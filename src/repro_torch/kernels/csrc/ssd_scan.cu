// ssd_scan for Hopper (sm_90a): the Mamba2 SSD chunked scan, the
// attention-free layer's sequence mixer in the full-sequence forward (the
// Preprocessor's reference forward).
//
// Replaces the Pallas kernel `ssd_scan` (_ssd_kernel) of
// src/repro/kernels/ssd_scan.py.
//
// What it computes, per (row b, head h) and chunk of Q tokens, with
// A_cum the inclusive prefix sum of dt * A over the chunk:
//   S'[i][j] = (C_i . B_j) * exp(A_cum[i] - A_cum[j]) * dt[j]  (i >= j, else 0)
//   y        = S' x + exp(A_cum) * (C state)
//   state    = exp(A_cum[Q-1]) state + B^T (exp(A_cum[Q-1] - A_cum) dt x)
// with the (N, P) state carried in float32 from chunk to chunk, starting at
// zero. Head h reads group h / (H / G) of B and C. y is written in x's
// dtype, the final state as (b, h, n, p) float32.
//
// What bounds it on the H100: the bytes. Each token of each head reads P
// values of x and one dt, each token of each group N values of B and C, and
// writes P values of y: ~216 MB at mamba2-2.7b's Preprocessor call (16 x
// 512 tokens, 80 heads of 64, state 128), 65 us at 3.35 TB/s. Its 3e10
// operations (the causal triangle of the two intra-chunk products, C.state
// and B^T.x) would take 30 us at the bf16 tensor-core rate but 443 us at
// the CUDA cores' float32 rate: only the tensor cores come near the bound.
//
// bfloat16 (mma_kernel, route "mma"): mma.sync m16n8k16 behind a ring of
// two chunk stages filled by 16-byte cp.async copies (mma_sync.cuh).
//  - A block owns (row b, `heads` heads of one B/C group) and walks the
//    row's chunks in order; the chunk's B and C tiles are loaded once for
//    its heads. Each head has one warp per 16 columns of P, so a warp owns
//    a (16, N) slice of the state transposed, state^T[p][n], in the
//    accumulator registers of the state product for the whole loop (64
//    floats a thread at N 128), and the (16, Q) slice y^T[p][i].
//  - Every product has one exact bf16 operand and one float32 operand split
//    in two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), ~16 bits; one
//    rounding exceeds the bf16 tolerance over a 512-token row
//    (tests/test_torch_ssd_tc.py emulates both):
//      S = C B^T          C, B exact, float32 sums (all operands exact);
//      S' in registers    the decay and dt applied per element, entries
//                         above the diagonal 0 by selection (never
//                         exp(positive) * 0), split, to shared memory;
//      y^T = state^T C^T  state^T split in registers (the accumulator
//                         fragments of two n8 tiles are the A fragment of
//                         one k16 step), C exact; columns scaled by
//                         exp(A_cum[i]);
//      y^T += x^T S'^T    x exact (ldmatrix.trans), S' split (ldmatrix),
//                         blocks above the diagonal skipped;
//      state^T = exp(A_cum[Q-1]) state^T + (w x)^T B, w = exp(A_cum[Q-1] -
//                         A_cum) dt folded into x's fragments and split in
//                         registers, B exact (ldmatrix.trans).
//  - A_cum is one warp's shuffle scan in float64 (scan_chunk). The head's
//    warps meet on a named barrier twice a chunk (the scan; S'), the block
//    once (the ring).
//  - N, P and Q are padded to 16 with zeros in shared memory (cp.async
//    zero-fills); padded rows and columns contribute exact zeros.
//  - The state's n8 tiles are template NT: 4 (N up to 32), 16 (up to 128)
//    or 32 (up to 256, in blocks of at most 256 threads so the 128 floats
//    a thread holds stay in registers). P up to 256: 16 warps a head.
//
// Both builds walk the row in chunks of at most 64 tokens. The scan does
// not depend on its chunking but for rounding, so for a longer chunk, or
// where the tiles of a chunk do not fit the block's shared memory, ops.py
// `_ssd_geometry` passes a divisor of it as Q. x, B and C whose strides or
// data are not 16-byte aligned are staged element by element through
// registers instead of by cp.async (`aligned` = 0; template AL, so the
// aligned kernels carry no code of it).
//
// float32 (fma_kernel, route "cuda-core"): one 256-thread block per (row,
// head), the same ring in float32, the state in shared memory. Each thread
// owns a register tile of every product (S: 4 x 4 with rows and columns 16
// apart, so a quarter warp reads 8 consecutive B rows; y: 4 rows x 4
// columns of each 64 of P; state: 4 rows x 4 columns of each 64 x 64 of
// (N, P)), read as float4 from rows padded by 16 bytes, with four partial
// sums per output split over k (the scan's sums cancel: at mamba2's widths
// |y| reaches ~400 where some entries are ~1).
// dt is folded into x as the Pallas kernel folds it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "load_store.cuh"
#include "mma_sync.cuh"

namespace repro {
namespace ssd {

// Mirrored field by field by ops.py `_SsdParams` (ctypes).
struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;
  // strides in elements: x (b, l, h), dt (b, l, h), B (b, l, g), C (b, l, g)
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb,
      c_sl, c_sg;
  int batch, L, H, P, G, N, Q;  // Q: the chunk the kernel walks, <= 64
  int qp, np, pp;  // Q, N and P padded to 16
  int heads;       // heads per block (float32: 1)
  int aligned;     // x, B and C: 16-byte aligned strides and data
  int smem;        // bytes of dynamic shared memory (ops.py _ssd_geometry)
};

constexpr int kFmaThreads = 256;

// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes of `src` into shared memory at `dst`, zero when !valid: by
// cp.async when the source is 16-byte aligned, else element by element
// through registers (visible to the block after its next barrier, as the
// ring's copies are).
template <bool AL, typename T>
__device__ __forceinline__ void copy16(unsigned char* dst, const T* src,
                                       bool valid) {
  if (AL) {
    cp16(dst, src, valid);
    return;
  }
  constexpr int V = 16 / (int)sizeof(T);
  __align__(16) T v[V];
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = valid ? src[e] : T(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// The `n` threads of named barrier `id` (a head's warps) meet.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory, in bytes, as ops.py `_ssd_geometry` lays it out: a ring of
// two stages [B][C][x of each head][dt of each head], then per head
// [S' (bf16: hi and lo; float32: once)][A_cum (float64)][exp(A_cum)][w]
// [decay] (float32: then the state). Rows are padded by 16 bytes, so
// ldmatrix and float4 reads of consecutive rows fall in distinct banks.
template <typename T>
struct Layout {
  int rowb, rowx, rows;  // a padded row of B and C, of x, of S'
  int bbytes, xbytes, sbytes, stage, head;
  __host__ __device__ explicit Layout(const Params& p) {
    constexpr int e = (int)sizeof(T);
    rowb = p.np * e + 16;
    rowx = p.pp * e + 16;
    rows = p.qp * e + 16;
    bbytes = p.qp * rowb;
    xbytes = p.qp * rowx;
    sbytes = p.qp * rows;
    stage = 2 * bbytes + p.heads * (xbytes + 4 * p.qp);
    head = (e == 2 ? 2 : 1) * sbytes + 16 * p.qp + 16 +
           (e == 2 ? 0 : p.np * rowx);
  }
};

// A block-strided walk over the (row, chunk) items of a (rows, n) matrix of
// 16-byte chunks, without a division per item.
struct Walk {
  int q, k, dq, dk, n;
  __device__ Walk(int tid, int nthr, int n_) : n(n_) {
    q = tid / n;
    k = tid - q * n;
    dq = nthr / n;
    dk = nthr - dq * n;
  }
  __device__ __forceinline__ void next() {
    k += dk;
    q += dq;
    if (k >= n) {
      k -= n;
      ++q;
    }
  }
};

// Chunk c's B, C, x of the block's heads and dt into ring stage `st`, zero
// past Q, N and P.
template <bool AL, typename T>
__device__ __forceinline__ void copy_chunk(const Params& p, const Layout<T>& lay,
                                           unsigned char* st, const T* bg,
                                           const T* cg, const T* xg,
                                           const float* dtg, int c, int tid,
                                           int nthr) {
  constexpr int V = 16 / (int)sizeof(T);
  const int q0 = c * p.Q;
  for (Walk it(tid, nthr, p.np / V); it.q < p.qp; it.next()) {
    const bool ok = it.q < p.Q && it.k * V < p.N;
    const long long r = q0 + it.q;
    copy16<AL>(st + it.q * lay.rowb + it.k * 16,
               ok ? bg + r * p.b_sl + it.k * V : bg, ok);
    copy16<AL>(st + lay.bbytes + it.q * lay.rowb + it.k * 16,
               ok ? cg + r * p.c_sl + it.k * V : cg, ok);
  }
  unsigned char* xs = st + 2 * lay.bbytes;
  for (int hs = 0; hs < p.heads; ++hs) {
    const T* xh = xg + hs * p.x_sh;
    for (Walk it(tid, nthr, p.pp / V); it.q < p.qp; it.next()) {
      const bool ok = it.q < p.Q && it.k * V < p.P;
      copy16<AL>(xs + hs * lay.xbytes + it.q * lay.rowx + it.k * 16,
                 ok ? xh + (q0 + it.q) * p.x_sl + it.k * V : xh, ok);
    }
  }
  float* ds = reinterpret_cast<float*>(xs + p.heads * lay.xbytes);
  for (int hs = 0; hs < p.heads; ++hs)
    for (int q = tid; q < p.qp; q += nthr) {
      const bool ok = q < p.Q;
      cp4(ds + hs * p.qp + q,
          ok ? dtg + hs * p.dt_sh + (long long)(q0 + q) * p.dt_sl : dtg, ok);
    }
}

// One warp: A_cum, the inclusive prefix sum of dt * a over the padded chunk
// (per-lane runs of at most two, then a shuffle scan of the runs), and from
// it exp(A_cum), w = exp(A_cum[Q-1] - A_cum) (times dt with fold_dt) and the
// chunk's decay exp(A_cum[Q-1]). The scan runs in float64 and A_cum is kept
// so: the decays read differences A_cum[i] - A_cum[j] of nearby rows, which
// a float32 tree of sums would leave several ulps of |A_cum| off (a
// sequential float32 sum leaves one), and float64 products of dt and a are
// exact. Padded rows have dt = 0, so their A_cum is the last row's and
// their w is 0.
__device__ __forceinline__ void scan_chunk(const float* dts, float a, int qp,
                                           int lane, double* acum,
                                           float* eac, float* w, float* decay,
                                           bool fold_dt) {
  const int per = (qp + 31) >> 5;
  double v[2], run = 0.0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = lane * per + k;
    v[k] = (k < per && q < qp) ? (double)dts[q] * (double)a : 0.0;
    run += v[k];
  }
  double inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  double ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0.0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = lane * per + k;
    ex += v[k];
    if (k < per && q < qp) acum[q] = ex;
  }
  __syncwarp();
  const double last = acum[qp - 1];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = lane * per + k;
    if (k < per && q < qp) {
      eac[q] = expf((float)acum[q]);
      const float wq = expf((float)(last - acum[q]));
      w[q] = fold_dt ? wq * dts[q] : wq;
    }
  }
  if (lane == 0) *decay = expf((float)last);
  __syncwarp();
}

// ---- bfloat16 on the tensor cores ------------------------------------------

// x's bf16 pair r (two k of one row) times (w0, w1), as hi and lo terms.
__device__ __forceinline__ void scale_split(uint32_t r, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
  split2(f.x * w0, f.y * w1, hi, lo);
}

// NT: n8 tiles of the state a warp can hold (N padded up to 8 NT); MAXW:
// warps a block may have; AL: x, B and C copied by cp.async. Lane (gid =
// lane / 4, tig = lane % 4) holds rows p = 16 wi + gid (+ 8) of the warp's
// y^T and state^T tiles, columns 8 t + 2 tig + {0, 1}.
template <int NT, int MAXW, bool AL>
__global__ void __launch_bounds__(32 * MAXW) mma_kernel(const Params p) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> lay(p);
  const int W = p.pp >> 4;  // warps per head
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  const int wid = tid >> 5, hs = wid / W, wi = wid - hs * W;
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, rr = lane & 7;
  const int b = blockIdx.y, h0 = blockIdx.x * p.heads, h = h0 + hs;
  const int g = h0 / (p.H / p.G);
  const int T16 = p.qp >> 4, ni = p.qp >> 3, nt8 = p.np >> 3;
  const int nc = p.L / p.Q;
  const int bar = 1 + hs, bar_n = 32 * W;

  unsigned char* ring = smem;
  unsigned char* shi = smem + 2 * lay.stage + hs * lay.head;
  unsigned char* slo = shi + lay.sbytes;
  double* acum = reinterpret_cast<double*>(slo + lay.sbytes);
  float* eac = reinterpret_cast<float*>(acum + p.qp);
  float* wv = eac + p.qp;
  float* dec = wv + p.qp;

  const T* xg = reinterpret_cast<const T*>(p.x) + b * p.x_sb + h0 * p.x_sh;
  const T* bg = reinterpret_cast<const T*>(p.B) + b * p.b_sb + g * p.b_sg;
  const T* cg = reinterpret_cast<const T*>(p.C) + b * p.c_sb + g * p.c_sg;
  const float* dtg = p.dt + b * p.dt_sb + h0 * p.dt_sh;
  const float a = p.A[h];
  T* yg = reinterpret_cast<T*>(p.y) + ((long long)b * p.L * p.H + h) * p.P;
  const long long ys = (long long)p.H * p.P;  // y's row stride
  const int p0 = 16 * wi + gid;                // the lane's rows of P

  float st[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[t][e] = 0.f;

  copy_chunk<AL>(p, lay, ring, bg, cg, xg, dtg, 0, tid, nthr);
  commit();
  for (int c = 0; c < nc; ++c) {
    wait_ring();     // this thread's copies of chunk c have landed
    __syncthreads();  // ... and everyone's; chunk c - 1 is done everywhere
    if (c + 1 < nc)
      copy_chunk<AL>(p, lay, ring + ((c + 1) & 1) * lay.stage, bg, cg, xg,
                     dtg, c + 1, tid, nthr);
    commit();
    const unsigned char* stg = ring + (c & 1) * lay.stage;
    const unsigned char* Bs = stg;
    const unsigned char* Cs = stg + lay.bbytes;
    const unsigned char* xs = stg + 2 * lay.bbytes + hs * lay.xbytes;
    const float* dts = reinterpret_cast<const float*>(
                           stg + 2 * lay.bbytes + p.heads * lay.xbytes) +
                       hs * p.qp;
    if (wi == 0) scan_chunk(dts, a, p.qp, lane, acum, eac, wv, dec, true);
    bar_sync(bar, bar_n);

    // S' in 16 x 16 blocks on and below the diagonal, dealt round the
    // head's warps
    int owner = 0;
    for (int it = 0; it < T16; ++it)
      for (int jb = 0; jb <= it; ++jb) {
        const bool mine = owner == wi;
        if (++owner == W) owner = 0;
        if (!mine) continue;
        float s[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
        for (int k = 0; k < p.np; k += 16) {
          uint32_t af[4], bf[4];
          ldsm_x4(af, Cs + (16 * it + (mi & 1) * 8 + rr) * lay.rowb +
                          (k + (mi >> 1) * 8) * 2);
          ldsm_x4(bf, Bs + (16 * jb + (mi >> 1) * 8 + rr) * lay.rowb +
                          (k + (mi & 1) * 8) * 2);
          mma16816(s[0], af, bf[0], bf[1]);
          mma16816(s[1], af, bf[2], bf[3]);
        }
        const int i0 = 16 * it + gid;
        const double ai[2] = {acum[i0], acum[i0 + 8]};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 16 * jb + 8 * t + 2 * tig;
          const double aj[2] = {acum[j], acum[j + 1]};
          const float dj[2] = {dts[j], dts[j + 1]};
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + (e >> 1) * 8, jj = j + (e & 1);
            v[e] = jj <= i ? s[t][e] * expf((float)(ai[e >> 1] - aj[e & 1])) *
                                 dj[e & 1]
                           : 0.f;
          }
          uint32_t h0w, l0w, h1w, l1w;
          split2(v[0], v[1], h0w, l0w);
          split2(v[2], v[3], h1w, l1w);
          *reinterpret_cast<uint32_t*>(shi + i0 * lay.rows + j * 2) = h0w;
          *reinterpret_cast<uint32_t*>(slo + i0 * lay.rows + j * 2) = l0w;
          *reinterpret_cast<uint32_t*>(shi + (i0 + 8) * lay.rows + j * 2) = h1w;
          *reinterpret_cast<uint32_t*>(slo + (i0 + 8) * lay.rows + j * 2) = l1w;
        }
      }
    bar_sync(bar, bar_n);

    // y^T: the carried state's term, scaled by exp(A_cum[i]), then S' x
    float y[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[t][e] = 0.f;
    if (c > 0) {
#pragma unroll
      for (int kb = 0; kb < NT / 2; ++kb) {
        if (2 * kb < nt8) {
          uint32_t ah[4], al[4];
          split2(st[2 * kb][0], st[2 * kb][1], ah[0], al[0]);
          split2(st[2 * kb][2], st[2 * kb][3], ah[1], al[1]);
          split2(st[2 * kb + 1][0], st[2 * kb + 1][1], ah[2], al[2]);
          split2(st[2 * kb + 1][2], st[2 * kb + 1][3], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 8; nt += 2) {
            if (nt < ni) {
              uint32_t bf[4];
              ldsm_x4(bf, Cs + (8 * nt + (mi >> 1) * 8 + rr) * lay.rowb +
                              (16 * kb + (mi & 1) * 8) * 2);
              mma16816(y[nt], ah, bf[0], bf[1]);
              mma16816(y[nt + 1], ah, bf[2], bf[3]);
              mma16816(y[nt], al, bf[0], bf[1]);
              mma16816(y[nt + 1], al, bf[2], bf[3]);
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < ni) {
          const int i = 8 * nt + 2 * tig;
          const float e0 = eac[i], e1 = eac[i + 1];
          y[nt][0] *= e0;
          y[nt][1] *= e1;
          y[nt][2] *= e0;
          y[nt][3] *= e1;
        }
      }
    }
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb < T16) {
        uint32_t af[4];
        ldsm_x4_t(af, xs + (16 * kb + (mi >> 1) * 8 + rr) * lay.rowx +
                          (16 * wi + (mi & 1) * 8) * 2);
#pragma unroll
        for (int nt = 2 * kb; nt < 8; nt += 2) {
          if (nt < ni) {
            uint32_t bh[4], bl[4];
            const int off = (8 * nt + (mi >> 1) * 8 + rr) * lay.rows +
                            (16 * kb + (mi & 1) * 8) * 2;
            ldsm_x4(bh, shi + off);
            ldsm_x4(bl, slo + off);
            mma16816(y[nt], af, bh[0], bh[1]);
            mma16816(y[nt + 1], af, bh[2], bh[3]);
            mma16816(y[nt], af, bl[0], bl[1]);
            mma16816(y[nt + 1], af, bl[2], bl[3]);
          }
        }
      }
    }
    T* yc = yg + (long long)c * p.Q * ys;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * nt + 2 * tig + (e & 1), pp = p0 + (e >> 1) * 8;
          if (i < p.Q && pp < p.P) store1(yc + i * ys + pp, y[nt][e]);
        }
      }
    }

    // state^T = decay state^T + (w x)^T B
    const float d = *dec;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] *= d;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb < T16) {
        uint32_t af[4], ah[4], al[4];
        ldsm_x4_t(af, xs + (16 * kb + (mi >> 1) * 8 + rr) * lay.rowx +
                          (16 * wi + (mi & 1) * 8) * 2);
        const int j = 16 * kb + 2 * tig;
        const float w0 = wv[j], w1 = wv[j + 1], w2 = wv[j + 8],
                    w3 = wv[j + 9];
        scale_split(af[0], w0, w1, ah[0], al[0]);
        scale_split(af[1], w0, w1, ah[1], al[1]);
        scale_split(af[2], w2, w3, ah[2], al[2]);
        scale_split(af[3], w2, w3, ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          if (nt < nt8) {
            uint32_t bf[4];
            ldsm_x4_t(bf, Bs + (16 * kb + (mi & 1) * 8 + rr) * lay.rowb +
                              (nt + (mi >> 1)) * 16);
            mma16816(st[nt], ah, bf[0], bf[1]);
            mma16816(st[nt + 1], ah, bf[2], bf[3]);
            mma16816(st[nt], al, bf[0], bf[1]);
            mma16816(st[nt + 1], al, bf[2], bf[3]);
          }
        }
      }
    }
  }
  float* so = p.state + ((long long)b * p.H + h) * p.N * p.P;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * t + 2 * tig + (e & 1), pp = p0 + (e >> 1) * 8;
        if (n < p.N && pp < p.P) so[n * p.P + pp] = st[t][e];
      }
    }
  }
}

// ---- float32 on the CUDA cores ---------------------------------------------

__device__ __forceinline__ float sum4(const float4& s) {
  return (s.x + s.y) + (s.z + s.w);
}

__device__ __forceinline__ void fma4(float4& acc, const float4& a,
                                     const float4& b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// y rows i = tr + 16 a (a < qp / 16) and columns c4 .. c4 + 3 of
// A (qp, K) times Bm (K, pp), K = kn: per output four partial sums over
// k mod 4, A read as float4 along k, Bm as float4 along the columns.
__device__ __forceinline__ void rows_times_cols(float (&out)[4][4],
                                                const float* A, int lda,
                                                const float* Bm, int ldb,
                                                int kn, int tr, int c4,
                                                int T16) {
  float4 acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[a][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < kn; k += 4) {
    float4 bk[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) bk[u] = ld4(Bm + (k + u) * ldb + c4);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a < T16) {
        const float4 av = ld4(A + (tr + 16 * a) * lda + k);
        // acc[a][col] holds column col's four partial sums
#pragma unroll
        for (int col = 0; col < 4; ++col)
          fma4(acc[a][col], av,
               make_float4(comp(bk[0], col), comp(bk[1], col),
                           comp(bk[2], col), comp(bk[3], col)));
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int col = 0; col < 4; ++col) out[a][col] = sum4(acc[a][col]);
}

template <bool AL>
__global__ void __launch_bounds__(kFmaThreads) fma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<float> lay(p);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int tr = tid >> 4, tc = tid & 15;  // a 16 x 16 grid of threads
  const int b = blockIdx.y, h = blockIdx.x;
  const int g = h / (p.H / p.G);
  const int T16 = p.qp >> 4, nc = p.L / p.Q;
  const int fb = lay.rowb / 4, fx = lay.rowx / 4, fs = lay.rows / 4;

  unsigned char* ring = smem;
  float* S = reinterpret_cast<float*>(smem + 2 * lay.stage);  // [qp][fs]
  double* acum = reinterpret_cast<double*>(S + p.qp * fs);
  float* eac = reinterpret_cast<float*>(acum + p.qp);
  float* wv = eac + p.qp;
  float* dec = wv + p.qp;
  float* stt = dec + 4;  // the state [np][fx]
  for (int e = tid; e < p.np * fx; e += kFmaThreads) stt[e] = 0.f;

  const float* xg = reinterpret_cast<const float*>(p.x) + b * p.x_sb +
                    h * p.x_sh;
  const float* bg = reinterpret_cast<const float*>(p.B) + b * p.b_sb +
                    g * p.b_sg;
  const float* cg = reinterpret_cast<const float*>(p.C) + b * p.c_sb +
                    g * p.c_sg;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float a = p.A[h];
  float* yg = reinterpret_cast<float*>(p.y) + ((long long)b * p.L * p.H + h) *
                                                  p.P;
  const long long ys = (long long)p.H * p.P;

  copy_chunk<AL>(p, lay, ring, bg, cg, xg, dtg, 0, tid, kFmaThreads);
  commit();
  for (int c = 0; c < nc; ++c) {
    wait_ring();
    __syncthreads();
    if (c + 1 < nc)
      copy_chunk<AL>(p, lay, ring + ((c + 1) & 1) * lay.stage, bg, cg, xg,
                     dtg, c + 1, tid, kFmaThreads);
    commit();
    unsigned char* stg = ring + (c & 1) * lay.stage;
    const float* Bs = reinterpret_cast<const float*>(stg);
    const float* Cs = reinterpret_cast<const float*>(stg + lay.bbytes);
    float* xs = reinterpret_cast<float*>(stg + 2 * lay.bbytes);
    const float* dts = reinterpret_cast<const float*>(stg + 2 * lay.bbytes +
                                                      lay.xbytes);
    if (wid == 0) scan_chunk(dts, a, p.qp, lane, acum, eac, wv, dec, false);
    // dt folded into x in place, as the Pallas kernel folds it
    for (int q = tr; q < p.qp; q += 16) {
      const float d = dts[q];
      for (int c4 = 4 * tc; c4 < p.pp; c4 += 64) {
        float4 v = ld4(xs + q * fx + c4);
        v.x *= d; v.y *= d; v.z *= d; v.w *= d;
        *reinterpret_cast<float4*>(xs + q * fx + c4) = v;
      }
    }
    __syncthreads();

    // S' = (C B^T) exp(A_cum[i] - A_cum[j]) on and below the diagonal:
    // rows i = tr + 16 a, columns j = tc + 16 jb
    {
      float4 acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < p.np; k += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < T16) cv[i] = ld4(Cs + (tr + 16 * i) * fb + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < T16) {
            const float4 bv = ld4(Bs + (tc + 16 * j) * fb + k);
#pragma unroll
            for (int i = j; i < 4; ++i)
              if (i < T16) fma4(acc[i][j], cv[i], bv);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < T16) {
          const int ii = tr + 16 * i;
          const double ai = acum[ii];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < T16) {
              const int jj = tc + 16 * j;
              S[ii * fs + jj] =
                  jj <= ii ? sum4(acc[i][j]) * expf((float)(ai - acum[jj]))
                           : 0.f;
            }
          }
        }
      }
    }
    __syncthreads();

    // y = exp(A_cum) (C state) + S' (dt x), 64 columns at a time
    for (int c4 = 4 * tc; c4 < p.pp; c4 += 64) {
      float yv[4][4], diag[4][4];
      if (c > 0) {
        rows_times_cols(yv, Cs, fb, stt, fx, p.np, tr, c4, T16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = i < T16 ? eac[tr + 16 * i] : 0.f;
#pragma unroll
          for (int col = 0; col < 4; ++col) yv[i][col] *= e;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int col = 0; col < 4; ++col) yv[i][col] = 0.f;
      }
      rows_times_cols(diag, S, fs, xs, fx, p.qp, tr, c4, T16);
      float* yc = yg + (long long)c * p.Q * ys;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = tr + 16 * i;
        if (i < T16 && ii < p.Q && c4 < p.P)
          *reinterpret_cast<float4*>(yc + ii * ys + c4) =
              make_float4(yv[i][0] + diag[i][0], yv[i][1] + diag[i][1],
                          yv[i][2] + diag[i][2], yv[i][3] + diag[i][3]);
      }
    }
    __syncthreads();  // every read of the old state is done

    // state = decay state + (w B)^T (dt x): rows n = n0 .. n0 + 3,
    // columns c4 .. c4 + 3, four partial sums over j mod 4
    const float d = *dec;
    for (int n0 = 4 * tr; n0 < p.np; n0 += 64) {
      for (int c4 = 4 * tc; c4 < p.pp; c4 += 64) {
        float4 acc[4][4];  // [row][j mod 4], the columns in the float4
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < p.qp; j += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float wj = wv[j + u];
            const float4 bn = ld4(Bs + (j + u) * fb + n0);
            const float4 xv = ld4(xs + (j + u) * fx + c4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float bw = comp(bn, i) * wj;
              acc[i][u].x = fmaf(bw, xv.x, acc[i][u].x);
              acc[i][u].y = fmaf(bw, xv.y, acc[i][u].y);
              acc[i][u].z = fmaf(bw, xv.z, acc[i][u].z);
              acc[i][u].w = fmaf(bw, xv.w, acc[i][u].w);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* sp = stt + (n0 + i) * fx + c4;
          float4 s = ld4(sp);
          s.x = fmaf(d, s.x, (acc[i][0].x + acc[i][1].x) +
                               (acc[i][2].x + acc[i][3].x));
          s.y = fmaf(d, s.y, (acc[i][0].y + acc[i][1].y) +
                               (acc[i][2].y + acc[i][3].y));
          s.z = fmaf(d, s.z, (acc[i][0].z + acc[i][1].z) +
                               (acc[i][2].z + acc[i][3].z));
          s.w = fmaf(d, s.w, (acc[i][0].w + acc[i][1].w) +
                               (acc[i][2].w + acc[i][3].w));
          *reinterpret_cast<float4*>(sp) = s;
        }
      }
    }
  }
  __syncthreads();
  float* so = p.state + ((long long)b * p.H + h) * p.N * p.P;
  for (int n = tr; n < p.N; n += 16)
    for (int q = tc; 4 * q < p.P; q += 16)
      *reinterpret_cast<float4*>(so + n * p.P + 4 * q) =
          ld4(stt + n * fx + 4 * q);
}

template <typename Kernel>
cudaError_t launch_ssd(Kernel kernel, const Params& p, int threads,
                       void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H / p.heads, p.batch), threads, p.smem,
           (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

// MAXW: the most warps a block of this NT may have (NT 32: 8, the state's
// 128 floats a thread in registers). Unaligned inputs take one instance,
// MAXW's, at every block size.
template <int NT, int MAXW>
cudaError_t launch_mma(const Params& p, void* stream) {
  const int threads = 32 * (p.pp / 16) * p.heads;
  if (threads > 32 * MAXW) return cudaErrorInvalidValue;
  if (!p.aligned)
    return launch_ssd(mma_kernel<NT, MAXW, false>, p, threads, stream);
  if (threads <= 128)
    return launch_ssd(mma_kernel<NT, 4, true>, p, threads, stream);
  if (threads <= 256)
    return launch_ssd(mma_kernel<NT, 8, true>, p, threads, stream);
  return launch_ssd(mma_kernel<NT, MAXW, true>, p, threads, stream);
}

// The launch's shapes and shared memory as this file's kernels take them:
// Q within one padded chunk of at most 64, padded N, P and Q, whole groups
// of heads, and `smem` holding the ring's two stages and the heads'
// scratch as `Layout` carves them.
template <typename T>
bool takes(const Params& p) {
  const Layout<T> lay(p);
  const int rep = p.G > 0 ? p.H / p.G : 0;
  return p.Q >= 1 && p.Q <= p.qp && p.qp <= 64 && p.qp % 16 == 0 &&
         p.np % 16 == 0 && p.np >= p.N && p.pp % 16 == 0 && p.pp >= p.P &&
         p.L % p.Q == 0 && p.heads >= 1 && rep % p.heads == 0 &&
         2LL * lay.stage + (long long)p.heads * lay.head <= p.smem;
}

}  // namespace ssd
}  // namespace repro

// dtype (of x, B, C and y): 0 = float32 (the CUDA cores), 1 = bfloat16
// (the tensor cores, state up to 32, 128 or 256 wide). dt and A are
// float32. Returns the launch's cudaError_t.
extern "C" int repro_ssd_scan(int dtype, const repro::ssd::Params* p,
                              void* stream) {
  using namespace repro::ssd;
  if (dtype == 0 && p->heads == 1 && takes<float>(*p))
    return (int)launch_ssd(p->aligned ? fma_kernel<true> : fma_kernel<false>,
                           *p, kFmaThreads, stream);
  if (dtype == 1 && takes<__nv_bfloat16>(*p)) {
    if (p->np <= 32) return (int)launch_mma<4, 16>(*p, stream);
    if (p->np <= 128) return (int)launch_mma<16, 16>(*p, stream);
    if (p->np <= 256) return (int)launch_mma<32, 8>(*p, stream);
  }
  return (int)cudaErrorInvalidValue;
}
