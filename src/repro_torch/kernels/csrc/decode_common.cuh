// The decode body shared by flash_decode (decode_attention.cu) and
// flash_decode_paged (paged_decode.cu): one-token GQA attention split
// across the SMs (flash-decoding), fed by an asynchronous ring of cp.async
// copies in the input dtype. The two kernels differ only in the
// key-address policy `Addr` they instantiate it with (slot: b, p, g through
// strides; paged: the row's block-table slice in shared memory, page and
// offset per 16-byte copy).
//
// Replaces the Pallas kernels `flash_decode` (src/repro/kernels/
// decode_attention.py) and `flash_decode_paged` (src/repro/kernels/
// paged_cache.py), both one grid step per (row, KV head, key block) with the
// online softmax carried across the sequential key axis.
//
// What bounds it on the H100: the bytes of K and V it reads. Per row b and
// KV head it does 2 * rep * len * D FLOPs per operand against 2 * len * D
// elements read, about rep FLOPs per byte in bf16 (rep = 4 for llama3-8b
// and granite-3-2b), two orders of magnitude under the card's ridge point.
// So the design keeps the memory busy and the rest of the work short:
//
//  - Split-KV in clusters. A block owns (split s, KV head g and a group of
//    at most 16 (bf16) or 8 (float32) of its query heads, row b); split s
//    covers key positions [s * span, (s + 1) * span). The wrapper chooses
//    the span from the shapes alone (ops.py `_decode_geometry`: a power of
//    two of splits, at most 8, keeping the grid in one wave of resident
//    blocks), so nothing of `lengths` is read on the host. The splits of a
//    row are one thread-block cluster: each leaves its float32 (m, l, acc)
//    in its shared memory, and split 0 merges the live ones through
//    distributed shared memory in order 0, 1, ...: no global partials, no
//    atomics, the same bits on every run. A split at or past lengths[b]
//    does no work (split 0 always runs, so a length-0 row gives zeros).
//  - Bytes in flight. Each of the 4 warps owns kw keys of every tile of
//    4 * kw keys (kw = 16 in bf16, 8 in float32, so that two stages fit at
//    head dim 256) and streams them through its own slots of a ring of
//    two tiles with 16-byte cp.async copies, zero-filled past lengths[b],
//    so no byte at or past the length is read: tile t + 1 is in flight
//    while tile t is computed (a third stage was never faster on the H100).
//    After the first tile (which waits for the block's q) a warp waits on
//    its own copies and a __syncwarp: no block-wide barrier in the loop.
//  - bf16 on the tensor cores (MmaWarp): mma.sync m16n8k16 with the query
//    heads padded to 16 rows, Q and K by ldmatrix, V by ldmatrix.trans; the
//    probabilities stay in registers and enter P V as two bf16 terms (hi and
//    lo), so they keep ~16 bits. float32 on the CUDA cores (FmaWarp):
//    scores and P V in registers from 16-byte chunks, q rows read as
//    shared-memory broadcasts, partial sums met by shuffles.
//
// Numerics as the Pallas kernels: scores, softmax, merges and output in
// float32, masked scores -1e30 with their probability 0 by selection, the
// output acc / max(l, 1e-30) rounded once. Every product-sum outside the
// mma is an explicit fmaf, so the two instantiations contract nothing
// differently: for the same values flash_decode_paged equals flash_decode
// on the gathered view bit for bit, at every page size.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "load_store.cuh"
#include "mma_sync.cuh"

namespace repro {
namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // tiles in the ring (ops.py _DEC_STAGES)

// Mirrored field by field by ops.py `_DecodeParams` (ctypes).
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* table;      // paged: (B, nb) block table, row-major; slot: null
  const int* lengths;    // (B,)
  void* out;
  // strides in elements. k_s0 / v_s0: per row b (slot) or per page (paged);
  // k_ss / v_ss: per position (slot) or per page offset (paged)
  long long q_sb, q_sh, k_s0, k_ss, k_sh, v_s0, v_ss, v_sh, o_sb, o_sh;
  int B, KV, rep;
  int nrg, rows, rmax;   // groups of query heads, heads per group, its pad
  int keys;              // CL (slot) or nb * ps (paged)
  int dk, dv;
  int span, nsplit;
  int head_bytes, smem;  // q and the table slice; the whole block
  int ps, ps_shift, nb;  // paged: page size, log2 of it (-1: not a power of
                         // two), block-table width
  float scale;
};

template <typename T>
struct Tile {
  static constexpr int kw = sizeof(T) == 2 ? 16 : 8;  // keys of a warp
  static constexpr int bk = kWarps * kw;              // keys of a tile
  static constexpr int v = 16 / (int)sizeof(T);       // elements per chunk
};

// ---- the ring's walk -------------------------------------------------------

// A lane's walk over the (row, chunk) items of a (rows, n) matrix of 16-byte
// chunks, 32 items apart, without a division per item.
struct Walk {
  int j, c, dj, dc, n;
  __device__ Walk(int lane, int n_) : n(n_) {
    j = lane / n; c = lane - j * n; dj = 32 / n; dc = 32 - dj * n;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    j += dj;
    if (c >= n) { c -= n; ++j; }
  }
};

// ---- a warp's keys: float32 on the CUDA cores ------------------------------

// Up to R (1, 2, 4, 8) query rows; the warp's 8 keys of a tile. Q K^T: four
// lanes per key, each a strided set of its 16-byte chunks against q rows
// read from shared memory as broadcasts, summed by shuffles. P V: lane
// (key group, column chunk) owns acc for all rows over its group's keys and
// takes each key's probabilities from the lane holding them by a shuffle.
template <int R>
struct FmaWarp {
  static constexpr int KW = Tile<float>::kw, V = Tile<float>::v;
  static constexpr int CPL = 2, LPK = 32 / KW;  // chunks of acc, lanes a key
  float m[R], l[R], acc[R][V * CPL];
  int key, half, cpow, kgrp, cc, kpg;

  __device__ FmaWarp(int lane, int cv) {
    key = lane % KW;
    half = lane / KW;
    cpow = 1;
    while (cpow < cv) cpow <<= 1;
    cpow = min(32, max(cpow, 32 / KW));
    kgrp = lane / cpow;
    cc = lane - kgrp * cpow;
    kpg = KW / (32 / cpow);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < V * CPL; ++e) acc[r][e] = 0.f;
    }
  }

  __device__ __forceinline__ void tile(const float* qs, int dk, int ck,
                                       int cv, const unsigned char* kt,
                                       int rowk, const unsigned char* vt,
                                       int rowv, bool valid_key, float scale) {
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    for (int c = half; c < ck; c += LPK) {
      float kf[V];
      load16(reinterpret_cast<const float*>(kt + key * rowk + c * 16), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(qs + r * dk + c * V);
        sc[r] = fmaf(x.x, kf[0], sc[r]);
        sc[r] = fmaf(x.y, kf[1], sc[r]);
        sc[r] = fmaf(x.z, kf[2], sc[r]);
        sc[r] = fmaf(x.w, kf[3], sc[r]);
      }
    }
#pragma unroll
    for (int o = KW; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);

    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = valid_key ? sc[r] * scale : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = KW / 2; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float corr = expf(m[r] - mn);
      p[r] = valid_key ? expf(x - mn) : 0.f;
      l[r] = fmaf(l[r], corr, p[r]);
#pragma unroll
      for (int e = 0; e < V * CPL; ++e) acc[r][e] *= corr;
      m[r] = mn;
    }

    for (int j = 0; j < kpg; ++j) {
      const int kk = kgrp * kpg + j;
      float pk[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pk[r] = __shfl_sync(0xffffffffu, p[r], kk);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = cc + 32 * i;
        if (c < cv) {
          float vf[V];
          load16(reinterpret_cast<const float*>(vt + kk * rowv + c * 16), vf);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int u = 0; u < V; ++u)
              acc[r][i * V + u] = fmaf(pk[r], vf[u], acc[r][i * V + u]);
        }
      }
    }
  }

  // l over the warp's keys and acc over its key groups, then into the
  // block's scratch: wm, wl [kWarps][R], wacc [kWarps][R][dv]
  __device__ __forceinline__ void finish(float* wm, float* wl, float* wacc,
                                         int w, int lane, int dv, int cv) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int o = KW / 2; o; o >>= 1)
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < V * CPL; ++e)
        for (int o = cpow; o < 32; o <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        wm[w * R + r] = m[r];
        wl[w * R + r] = l[r];
      }
    }
    if (kgrp == 0) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = cc + 32 * i;
        if (c < cv)
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int u = 0; u < V; ++u)
              wacc[(w * R + r) * dv + c * V + u] = acc[r][i * V + u];
      }
    }
  }
};

// ---- a warp's keys: bfloat16 on the tensor cores ---------------------------

// The warp's 16 keys of a tile against the block's query rows padded to the
// mma's 16 (rows past `rows` are zero), with mma.sync m16n8k16: S (16 x 16
// keys) = Q K^T over the head dim in k16 steps, Q and K by ldmatrix; P stays
// in registers (the S accumulator is the P V product's A operand) and
// enters as hi + lo bf16 terms; O (16 x dv) += P V, V by ldmatrix.trans.
// Lane (gid = lane / 4, tig = lane % 4) holds rows gid and gid + 8 and keys
// 8j + 2 tig + {0, 1} of S, and of O columns 8n + 2 tig + {0, 1}.
template <int DM>
struct MmaWarp {
  static_assert(Tile<__nv_bfloat16>::kw == 16, "a warp's keys: one k16 step");
  static constexpr int NT = DM / 8;  // n8 column tiles of O
  float o[NT][4], m[2], l[2];
  int gid, tig, mi, rr;

  __device__ MmaWarp(int lane, int) {
    gid = lane >> 2;
    tig = lane & 3;
    mi = lane >> 3;
    rr = lane & 7;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // qs: the (16, dk) bf16 Q tile, rows 2 dk + 16 bytes apart; the tile's keys
  // valid below `valid_below` (relative to the warp's first key)
  __device__ __forceinline__ void tile(const unsigned char* qs, int rowq,
                                       int dk, int dv, const unsigned char* kt,
                                       int rowk, const unsigned char* vt,
                                       int rowv, int valid_below,
                                       float scale) {
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    for (int k = 0; k < dk; k += 16) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qs + ((mi & 1) * 8 + rr) * rowq + (k + (mi >> 1) * 8) * 2);
      ldsm_x4(b, kt + ((mi >> 1) * 8 + rr) * rowk + (k + (mi & 1) * 8) * 2);
      mma16816(s[0], a, b[0], b[1]);
      mma16816(s[1], a, b[2], b[3]);
    }

    // online softmax of rows gid (c = 0, 1) and gid + 8 (c = 2, 3); the four
    // lanes of a row meet by shuffles; p = 0 for a masked key
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = j * 8 + tig * 2 + (c & 1) < valid_below;
        s[j][c] = ok ? s[j][c] * scale : kNegInf;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - mn);
      m[h] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = j * 8 + tig * 2 + (c & 1) < valid_below;
        s[j][c] = ok ? expf(s[j][c] - m[c >> 1]) : 0.f;
        sum[c >> 1] += s[j][c];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], corr[h], sum[h]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    uint32_t ph[4], pl[4];
    split2(s[0][0], s[0][1], ph[0], pl[0]);
    split2(s[0][2], s[0][3], ph[1], pl[1]);
    split2(s[1][0], s[1][1], ph[2], pl[2]);
    split2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n * 8 < dv) {
        uint32_t b[4];
        ldsm_x4_t(b, vt + ((mi & 1) * 8 + rr) * rowv + (n + (mi >> 1)) * 16);
        mma16816(o[n], ph, b[0], b[1]);
        mma16816(o[n], pl, b[0], b[1]);
        mma16816(o[n + 1], ph, b[2], b[3]);
        mma16816(o[n + 1], pl, b[2], b[3]);
      }
    }
  }

  // l over the row's four lanes, then into the block's scratch: wm, wl
  // [kWarps][RP], wacc [kWarps][RP][dv], rows below RP only
  __device__ __forceinline__ void finish(float* wm, float* wl, float* wacc,
                                         int w, int RP, int dv) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gid + 8 * h;
      if (r >= RP) continue;
      if (tig == 0) {
        wm[w * RP + r] = m[h];
        wl[w * RP + r] = l[h];
      }
      float* dst = wacc + (w * RP + r) * dv + tig * 2;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n * 8 < dv) {
          dst[n * 8] = o[n][2 * h];
          dst[n * 8 + 1] = o[n][2 * h + 1];
        }
    }
  }
};

// ---- the split kernel ------------------------------------------------------

// T = float: the CUDA-core warps with R (= Params.rmax) rows (DM unused);
// T = bf16: the tensor-core warps, O held for head dims up to DM (R unused).
template <typename T, int R, int DM, typename Addr>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Params P) {
  using G = Tile<T>;
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int KW = G::kw, BK = G::bk, V = G::v;
  extern __shared__ __align__(16) unsigned char smem[];

  const int s = blockIdx.x, gy = blockIdx.y, b = blockIdx.z;
  const int g = gy / P.nrg, rg = gy - g * P.nrg;
  const int len = max(0, min(__ldg(P.lengths + b), P.keys));
  const int k0 = s * P.span;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  if (s > 0 && k0 >= len) {  // nothing of this split is valid
    cluster.sync();           // (the cluster's two barriers, see the end)
    cluster.sync();
    return;
  }
  const int k1 = min(k0 + P.span, len);
  const int nact = max(1, (len + P.span - 1) / P.span);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int h0 = g * P.rep + rg * P.rows;  // first query head of the block
  const int rows = min(P.rows, P.rep - rg * P.rows);
  const int RP = P.rmax;
  const int ck = P.dk / V, cv = P.dv / V;
  const int rowq = P.dk * 2 + 16;               // bf16 Q tile rows
  const int rowk = P.dk * (int)sizeof(T) + 16;  // +16: conflict-free rows
  const int rowv = P.dv * (int)sizeof(T) + 16;
  const int slot_bytes = KW * (rowk + rowv);

  // [q][table slice] then the ring
  unsigned char* qs = smem;
  int* table = reinterpret_cast<int*>(qs + (kMma ? 16 * rowq : R * P.dk * 4));
  unsigned char* ring = smem + P.head_bytes;  // [kStages][kWarps] slots
  const Addr addr(P, b, g, k0, k1, table);  // paged: loads its table slice
  if (Addr::kTable) __syncthreads();        // ... before any key's address

  // q: the (16, dk) bf16 tile (mma) or (R, dk) float32 rows, zero past
  // `rows`, copied in the first group, with tile 0
  const T* qg = reinterpret_cast<const T*>(P.q) + b * P.q_sb + h0 * P.q_sh;
  for (int e = tid; e < (kMma ? 16 : R) * ck; e += kThreads) {
    const int r = e / ck, c = e - r * ck;
    cp16(qs + (kMma ? r * rowq : r * P.dk * 4) + c * 16,
         r < rows ? qg + r * P.q_sh + c * V : qg, r < rows);
  }

  const T* kg = reinterpret_cast<const T*>(P.k);
  const T* vg = reinterpret_cast<const T*>(P.v);
  const Walk wk0(lane, ck), wv0(lane, cv);
  const int nt = (k1 - k0 + BK - 1) / BK;

  // warp w's keys of tile t into its slot of stage t % kStages, zero past len
  auto copy = [&](int t) {
    const int p0 = k0 + t * BK + w * KW;
    if (p0 >= len) return;
    unsigned char* dst = ring + ((t % kStages) * kWarps + w) * slot_bytes;
    for (Walk it = wk0; it.j < KW; it.next()) {
      const int p = p0 + it.j;
      const bool ok = p < len;
      cp16(dst + it.j * rowk + it.c * 16,
           ok ? kg + addr.k(p) + it.c * V : kg, ok);
    }
    dst += KW * rowk;
    for (Walk it = wv0; it.j < KW; it.next()) {
      const int p = p0 + it.j;
      const bool ok = p < len;
      cp16(dst + it.j * rowv + it.c * 16,
           ok ? vg + addr.v(p) + it.c * V : vg, ok);
    }
  };

  using Warp = typename std::conditional<kMma, MmaWarp<DM>, FmaWarp<R>>::type;
  Warp warp(lane, cv);
  static_assert(kStages == 2, "the loop waits for tile t alone in flight");
  if (nt > 0) copy(0);
  commit();
  for (int t = 0; t < nt; ++t) {
    wait_ring();  // this lane's copies of tile t have landed
    if (t == 0)
      __syncthreads();  // ... and the block's copies of q
    else
      __syncwarp();     // ... and the warp's; the warp is done with tile t-1
    if (t + 1 < nt) copy(t + 1);
    commit();
    const int p0 = k0 + t * BK + w * KW;
    if (p0 >= len) continue;  // the warp's keys of this tile are all masked
    const unsigned char* kt = ring + ((t % kStages) * kWarps + w) * slot_bytes;
    const unsigned char* vt = kt + KW * rowk;
    if constexpr (kMma)
      warp.tile(qs, rowq, P.dk, P.dv, kt, rowk, vt, rowv, len - p0, P.scale);
    else
      warp.tile(reinterpret_cast<const float*>(qs), P.dk, ck, cv, kt, rowk,
                vt, rowv, p0 + lane % KW < len, P.scale);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // every warp is done with the ring: the scratch reuses it

  float* wacc = reinterpret_cast<float*>(ring);  // [kWarps][RP][dv]
  float* wm = wacc + kWarps * RP * P.dv;         // [kWarps][RP]
  float* wl = wm + kWarps * RP;                  // [kWarps][RP]
  float* fac = wl + kWarps * RP;                 // [kWarps][RP]
  float* bm = fac + kWarps * RP;                 // [RP]
  float* bl = bm + RP;                           // [RP]
  float* ba = bl + RP;                           // [RP][dv]
  if constexpr (kMma)
    warp.finish(wm, wl, wacc, w, RP, P.dv);
  else
    warp.finish(wm, wl, wacc, w, lane, P.dv, cv);
  __syncthreads();
  // the block's state: the warps merged in order 0 .. kWarps-1
  if (tid < RP) {
    float M = kNegInf;
    for (int x = 0; x < kWarps; ++x) M = fmaxf(M, wm[x * RP + tid]);
    float L = 0.f;
    for (int x = 0; x < kWarps; ++x) {
      const float f = expf(wm[x * RP + tid] - M);
      fac[x * RP + tid] = f;
      L = fmaf(wl[x * RP + tid], f, L);
    }
    bm[tid] = M;
    bl[tid] = L;
  }
  __syncthreads();
  T* out = reinterpret_cast<T*>(P.out) + b * P.o_sb;
  for (int e = tid; e < rows * P.dv; e += kThreads) {
    const int r = e / P.dv, d = e - r * P.dv;
    float A = 0.f;
    for (int x = 0; x < kWarps; ++x)
      A = fmaf(wacc[(x * RP + r) * P.dv + d], fac[x * RP + r], A);
    if (nact == 1)  // the row's only split: the output
      store1(out + (h0 + r) * P.o_sh + d, A / fmaxf(bl[r], 1e-30f));
    else            // a partial, in this block's shared memory
      ba[r * P.dv + d] = A;
  }
  if (P.nsplit == 1) return;
  // The row's splits are one cluster (block rank s). After the first
  // barrier split 0 reads the live splits' (bm, bl, ba) from their shared
  // memory and merges them in order 0, 1, ...; the second keeps every
  // block's shared memory alive until it has.
  cluster.sync();
  if (s == 0 && nact > 1) {
    for (int e = tid; e < rows * P.dv; e += kThreads) {
      const int r = e / P.dv, d = e - r * P.dv;
      float M = kNegInf;
      for (int x = 0; x < nact; ++x)
        M = fmaxf(M, *cluster.map_shared_rank(bm + r, x));
      float L = 0.f, A = 0.f;
      for (int x = 0; x < nact; ++x) {
        const float f = expf(*cluster.map_shared_rank(bm + r, x) - M);
        L = fmaf(*cluster.map_shared_rank(bl + r, x), f, L);
        A = fmaf(*cluster.map_shared_rank(ba + r * P.dv + d, x), f, A);
      }
      store1(out + (h0 + r) * P.o_sh + d, A / fmaxf(L, 1e-30f));
    }
  }
  cluster.sync();
}

template <typename T, int R, int DM, typename Addr>
cudaError_t launch_split(const Params& P, void* stream) {
  auto kernel = split_kernel<T, R, DM, Addr>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = P.nsplit;  // a row's splits: one cluster
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.nsplit, P.KV * P.nrg, P.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, P);
}

// dtype 0 (float32): the instance of P.rmax rows (1, 2, 4, 8); dtype 1
// (bfloat16): the instance holding O for the value head dim (up to 64, 128,
// 256).
template <typename Addr>
int run_dtype(int dtype, const Params* P, void* stream) {
  if (dtype == 0) {
    switch (P->rmax) {
      case 1: return (int)launch_split<float, 1, 64, Addr>(*P, stream);
      case 2: return (int)launch_split<float, 2, 64, Addr>(*P, stream);
      case 4: return (int)launch_split<float, 4, 64, Addr>(*P, stream);
      case 8: return (int)launch_split<float, 8, 64, Addr>(*P, stream);
    }
  } else if (dtype == 1) {
    if (P->dv <= 64)
      return (int)launch_split<__nv_bfloat16, 16, 64, Addr>(*P, stream);
    if (P->dv <= 128)
      return (int)launch_split<__nv_bfloat16, 16, 128, Addr>(*P, stream);
    if (P->dv <= 256)
      return (int)launch_split<__nv_bfloat16, 16, 256, Addr>(*P, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace dec
}  // namespace repro
