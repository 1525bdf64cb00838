// Tensor-core attention core for Hopper (sm_90a), shared by the bfloat16
// builds of flash_attention and prefill_attention.
//
// One block owns kRows = 128 query rows that all read the same KV head,
// held as two consumer warpgroups of 64 rows; a ninth warp is the
// producer. Q is copied into shared memory once, by all threads, in the
// 128-byte swizzled layout wgmma reads. K and V arrive in tiles of kKeys =
// 64 keys by TMA (cp.async.bulk.tensor) into a ring of `stages` buffers:
// the producer's lane 0 waits for a buffer to be released (`empty`
// mbarrier, one arrival per consumer warp), then issues the tile's loads,
// which complete on the buffer's `full` mbarrier; the loads of the next
// tiles are in flight while a tile is computed. The tensor maps carry the
// callers' strides, and TMA's out-of-bounds fill writes zeros past the
// last key and past the head dim, so ragged edges need no special load.
//
// A head dim is cut into panels of 64 bfloat16 (128 bytes, the swizzle's
// span); a K or V tile is 64 x 64 per panel, Q 128 x 64.
//
// prefill_attention's head dims past kMaxDim (absorbed MLA: Dk 576 = 512 +
// 64, Dv 512) take the wide instance (SPLIT): Q's 9 panels of 128 rows and
// a 17-panel K/V stage cannot both fit twice in 227 KB, and O of 128 rows x
// 512 columns would need 256 float32 registers a thread. So a block owns
// kWideRows = 64 rows, which both consumer warpgroups hold: each computes S
// and the softmax of all 64 rows itself (the same values in both), and
// accumulates half of O's panels (4 x 64 columns, 128 registers a thread),
// so nothing passes between the two. K and V come in tiles of kWideKeys =
// 32 keys (S is a wgmma m64n32k16) through two stages: Q 72 KB, a stage 68
// KB, 209 KB in all.
//
// Per key tile each consumer warpgroup computes
//   S = Q K^T        wgmma m64n64k16, Q and K both K-major in shared memory
//   online softmax   on S's accumulator fragments, in float32, base 2
//   O += P V         wgmma m64n64k16 per V panel, P from registers (the
//                    accumulator fragment of S is the A fragment of PV once
//                    rounded to bfloat16), V read MN-major (transpose bit)
// Masked scores are -1e30, chosen by selection; only tiles that cross a
// mask edge evaluate the mask, and a tile masked for all of a warpgroup's
// rows is skipped. The denominator sums the float32 probabilities. P enters
// the PV product as two bfloat16 terms, bf16(P) and bf16(P - bf16(P)), in
// two wgmmas: about 16 bits of P where one bfloat16 keeps 8, so the output
// stays within an ulp or two of the float32-P plain version even after
// many layers (the serve phase's logits check), for a second PV wgmma per
// tile. The output is O / max(l, 1e-30), rounded once to bfloat16.
#pragma once

#include <type_traits>

#include "tc_common.cuh"

namespace repro {
namespace tc {

constexpr int kRows = 128;                 // query rows of a block
constexpr int kKeys = 64;                  // keys of a K/V tile
constexpr int kPanel = 64;                 // bfloat16 columns of a panel
constexpr int kPanelBytes = kKeys * 128;   // a 64 x 64 K or V panel
constexpr int kQPanelBytes = kRows * 128;  // a 128 x 64 Q panel
constexpr int kMaxStages = 4;
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// the wide instance: its rows, keys of a tile and panels (Dk up to 576, Dv
// up to 512, kWideNV V panels per warpgroup)
constexpr int kWideRows = 64;
constexpr int kWideKeys = 32;
constexpr int kWidePK = 9;
constexpr int kWideNV = 4;
constexpr int kWideMaxDk = kWidePK * kPanel;
constexpr int kWideMaxDv = 2 * kWideNV * kPanel;

// Shared memory of one block: 1024 bytes of slack to align the swizzled
// buffers, Q's pk panels of `rows` rows, the ring's K and V panels of
// `keys` rows, 2 * kMaxStages mbarriers. The ring takes as many stages as
// fit, at most kMaxStages. kernels/ops.py `_tc_geometry` and
// `_tc_wide_geometry` compute the same numbers.
struct Geometry {
  int pk, pv, stages;
  size_t smem;
};

inline Geometry ring_geometry(int pk, int pv, int rows, int keys) {
  Geometry g;
  g.pk = pk;
  g.pv = pv;
  const size_t fixed = 1024 + (size_t)pk * rows * 128 + 16 * kMaxStages;
  const size_t stage = (size_t)(pk + pv) * keys * 128;
  const size_t fit = (kSmemLimit - fixed) / stage;
  g.stages = (int)(fit < (size_t)kMaxStages ? fit : (size_t)kMaxStages);
  g.smem = fixed + (size_t)g.stages * stage;
  return g;
}

inline Geometry geometry(int dk, int dv) {
  return ring_geometry((dk + kPanel - 1) / kPanel, (dv + kPanel - 1) / kPanel,
                       kRows, kKeys);
}

// The wide instance reserves its 9 + 8 panels whatever the head dims.
inline Geometry wide_geometry() {
  return ring_geometry(kWidePK, 2 * kWideNV, kWideRows, kWideKeys);
}

// ---- shared memory ---------------------------------------------------------

struct Smem {
  uint32_t q;      // shared-window addresses, 1024-aligned
  uint32_t ring;   // stage s: K panels at ring + s * stage_bytes, then V
  uint32_t full;   // mbarrier of stage s at full + 8 s
  uint32_t empty;
  uint8_t* q_ptr;  // generic pointer to Q, for the threads' copy
  int stage_bytes, v_off;
};

// rows: Q's rows (a panel is rows x 128 bytes); keys: a K/V tile's.
__device__ __forceinline__ Smem carve(uint8_t* raw, int pk, int pv,
                                      int stages, int rows = kRows,
                                      int keys = kKeys) {
  Smem sm;
  const uint32_t base = smem_u32(raw);
  const uint32_t pad = (1024 - (base & 1023)) & 1023;
  sm.q_ptr = raw + pad;
  sm.q = base + pad;
  sm.ring = sm.q + pk * rows * 128;
  sm.stage_bytes = (pk + pv) * keys * 128;
  sm.v_off = pk * keys * 128;
  sm.full = sm.ring + stages * sm.stage_bytes;
  sm.empty = sm.full + 8 * kMaxStages;
  return sm;
}

// ---- wgmma -----------------------------------------------------------------

#define REPRO_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define REPRO_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (+)= A B, A and B K-major in shared memory; accumulate iff `acc`.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32(d)
      : "l"(da), "l"(db), "r"(acc));
}

// The same for a 32-key tile (the wide instance): m64n32k16.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B, A (bf16 pairs) in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- block set-up ----------------------------------------------------------

// Copy rows [0, nrows) of Q into its panels of `rows` rows, 16 bytes a
// thread, in the 128-byte swizzle (chunk c of row i at chunk c ^ (i % 8));
// rows past nrows and columns past dk are zero. Then initialise the ring's
// barriers, make both visible to the async proxy, and sync the block.
template <typename RowPtr>
__device__ __forceinline__ void setup(const Smem& sm, int dk, int pk,
                                      int nrows, int stages, RowPtr row_ptr,
                                      int rows = kRows) {
  const int chunks = pk * 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int i = idx / chunks, c = idx % chunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < nrows && c * 8 < dk)
      v = *reinterpret_cast<const uint4*>(row_ptr(i) + c * 8);
    *reinterpret_cast<uint4*>(sm.q_ptr + (c / 8) * rows * 128 + i * 128 +
                              (((c % 8) ^ (i & 7)) << 4)) = v;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// The producer's loop, run by lane 0 of the last warp: tile t goes to
// stage t % stages once its previous contents are released. `issue(t,
// k_dst, v_dst, bar)` issues the tile's TMA loads, `bytes` in all.
template <typename Issue>
__device__ __forceinline__ void produce(const Smem& sm, uint32_t bytes,
                                        int stages, int ntiles, Issue issue) {
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % stages;
    mbar_wait(sm.empty + 8 * s, ((t / stages) & 1) ^ 1);
    mbar_expect_tx(sm.full + 8 * s, bytes);
    const uint32_t k_dst = sm.ring + s * sm.stage_bytes;
    issue(t, k_dst, k_dst + sm.v_off, sm.full + 8 * s);
  }
}

// ---- one consumer warpgroup ------------------------------------------------

// The online-softmax state of a warpgroup's 64 rows. Thread (warp w of the
// warpgroup, lane l) holds rows 16 w + l / 4 and that + 8; accumulator
// entry 4 j + 2 i + c is row (l / 4) + 8 i, column 8 j + 2 (l % 4) + c of
// its 64-column tile (of S: its KEYS-column tile). PK and NV are the
// numbers of 64-column panels of Q/K and of the warpgroup's V; the columns
// past dk in the last Q/K panel are zeros, so S runs over all 4 PK k16
// steps, unrolled. SPLIT: the wide instance, both warpgroups on the same
// 64 rows, warpgroup w on V panels w NV .. w NV + NV - 1.
//
// The tiles are pipelined inside the warpgroup: tile t's S = Q K^T is
// issued together with the previous tile's O += P V, so the tensor cores
// run PV while the warpgroup waits for S, and the softmax of tile t runs
// while PV may still be in flight; the previous tile's stage is released
// once its PV has completed.
template <int PK, int NV, int KEYS = kKeys, bool SPLIT = false>
struct Consumer {
  static constexpr int kSteps = KEYS / 16;     // k16 steps of P V a tile
  static constexpr int kFrag = KEYS / 2;       // S entries of a thread
  static constexpr int kKeyPanel = KEYS * 128; // bytes of a K or V panel
  static constexpr int kQPanel = (SPLIT ? 64 : kRows) * 128;
  float o[NV][32];
  float m[2], l[2];
  uint32_t a[kSteps][4];     // P of the pending tile: bf16 pairs, keys
  uint32_t a_lo[kSteps][4];  // 16 kk .., and P - bf16(P), in bf16
  int wg, lane;

  __device__ __forceinline__ void init() {
    // broadcast from lane 0, so the compiler knows the warpgroup index,
    // and every branch on it around a wgmma, to be uniform
    wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
    lane = threadIdx.x % 32;
#pragma unroll
    for (int p = 0; p < NV; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // this thread's first row within the block's rows
  __device__ __forceinline__ int row() const {
    return (SPLIT ? 0 : wg * 64) + ((threadIdx.x % 128) / 32) * 16 +
           lane / 4;
  }
  // the first of this warpgroup's V panels
  __device__ __forceinline__ int panel0() const { return SPLIT ? wg * NV : 0; }
  // the key offset within a tile of accumulator entry (j, c)
  __device__ __forceinline__ int key(int j, int c) const {
    return 8 * j + 2 * (lane % 4) + c;
  }

  __device__ __forceinline__ void issue_s(float (&s)[kFrag], const Smem& sm,
                                          uint32_t k_tile) const {
    const uint32_t q_rows = sm.q + (SPLIT ? 0 : wg * 64 * 128);
#pragma unroll
    for (int kk = 0; kk < 4 * PK; ++kk) {
      const uint32_t off = (kk / 4) * kQPanel + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kKeyPanel + (kk % 4) * 32;
      wgmma_ss(s, desc(q_rows + off, 16, 1024), desc(k_tile + koff, 16, 1024),
               kk > 0);
    }
  }

  __device__ __forceinline__ void issue_pv(uint32_t v_tile) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int p = 0; p < NV; ++p) {
        const uint64_t dv = desc(
            v_tile + (panel0() + p) * kKeyPanel + kk * 16 * 128, 1024, 1024);
        wgmma_rs(o[p], a[kk], dv);
        wgmma_rs(o[p], a_lo[kk], dv);
      }
  }

  // The registers of P stay untouched until its PV has completed.
  __device__ __forceinline__ void fence_p() {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        asm volatile("" : "+r"(a[kk][r])::"memory");
        asm volatile("" : "+r"(a_lo[kk][r])::"memory");
      }
  }

  // Scores to probabilities in place, in base 2, with the running max and
  // denominator; returns the factor the previous rows' O must take.
  template <typename Valid>
  __device__ __forceinline__ void softmax(float (&s)[kFrag], float (&corr)[2],
                                          float scale_log2, bool masked,
                                          Valid valid) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float x = s[e] * scale_log2;
          if (masked && !valid(i, key(j, c))) x = kNegInf;
          s[e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int e = 0; e < kFrag; ++e) {
      const int i = (e / 2) % 2;
      s[e] = exp2f(s[e] - mx[i]);
      l[i] += s[e];
    }
  }

  // Rescale O, and make the tile's P the pending A fragments.
  __device__ __forceinline__ void take(const float (&s)[kFrag],
                                       const float (&corr)[2]) {
#pragma unroll
    for (int p = 0; p < NV; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] *= corr[(e / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        a[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
        a_lo[kk][r] = pack_bf16(x0 - hf.x, x1 - hf.y);
      }
  }

  // Release a ring stage: one arrival per consumer warp, after the
  // warpgroup's wgmma reads of it have completed.
  __device__ __forceinline__ void release(const Smem& sm, int s) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + 8 * s);
  }

  // Every key tile of the block, in the producer's order. kind(t): 0 when
  // tile t is masked for all of the warpgroup's rows (skipped), 1 when no
  // key of it is masked for any of them, 2 when the mask must be evaluated;
  // valid(t, i, jj): whether this thread's row i (0 or 1) may attend key jj
  // of tile t.
  template <typename Kind, typename Valid>
  __device__ __forceinline__ void run(const Smem& sm, int ntiles,
                                      int stages, float scale_log2, Kind kind,
                                      Valid valid) {
    // the tiles masked for all rows before the first one computed
    int t = 0;
    for (; t < ntiles; ++t) {
      mbar_wait(sm.full + 8 * (t % stages), (t / stages) & 1);
      if (kind(t) != 0) break;
      release(sm, t % stages);
    }
    if (t == ntiles) return;
    // the first tile computed: S alone
    int pend = t % stages;  // the stage whose P V is not issued yet
    {
      float sc[kFrag], corr[2];
      wg_fence();
      issue_s(sc, sm, sm.ring + pend * sm.stage_bytes);
      wg_commit();
      wg_wait<0>();
      reg_fence(sc);
      softmax(sc, corr, scale_log2, kind(t) == 2,
              [&](int i, int jj) { return valid(t, i, jj); });
      take(sc, corr);
    }
    // then S of tile t beside P V of the tile before
    for (++t; t < ntiles; ++t) {
      const int s = t % stages;
      mbar_wait(sm.full + 8 * s, (t / stages) & 1);
      const int k = kind(t);
      if (k == 0) {
        release(sm, s);
        continue;
      }
      float sc[kFrag], corr[2];
      wg_fence();
      issue_s(sc, sm, sm.ring + s * sm.stage_bytes);
      wg_commit();
      issue_pv(sm.ring + pend * sm.stage_bytes + sm.v_off);
      wg_commit();
      wg_wait<1>();
      reg_fence(sc);
      softmax(sc, corr, scale_log2, k == 2,
              [&](int i, int jj) { return valid(t, i, jj); });
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NV; ++p) reg_fence(o[p]);
      fence_p();
      release(sm, pend);
      take(sc, corr);
      pend = s;
    }
    wg_fence();
    issue_pv(sm.ring + pend * sm.stage_bytes + sm.v_off);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NV; ++p) reg_fence(o[p]);
    fence_p();
    release(sm, pend);
  }

  // Write O / max(l, 1e-30) in bfloat16 for this thread's rows below
  // `nrows`, this warpgroup's columns; out_ptr(r) is row r's start (r
  // within the block's rows).
  template <typename OutPtr>
  __device__ __forceinline__ void store(int nrows, int dv, OutPtr out_ptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row() + 8 * i;
      if (r >= nrows) continue;
      bf16* dst = out_ptr(r);
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int p = 0; p < NV; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = (panel0() + p) * kPanel + key(j, 0);
          if (col < dv)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(o[p][4 * j + 2 * i] / den,
                                      o[p][4 * j + 2 * i + 1] / den);
        }
    }
  }
};

// ---- host side -------------------------------------------------------------

// The map of a bfloat16 tensor read as (n3, n2, n1, d) with element
// strides s3, s2, s1 and a contiguous last dim, in boxes of 64 columns x
// `keys` rows over (d, n1) with the 128-byte swizzle; reads past d or n1
// fill zeros. A stride of a dimension of size 1 is never used, and is
// replaced by a valid one.
inline int make_map(CUtensorMap* map, const void* base, int d, int n1, int n2,
                    int n3, long long s1, long long s2, long long s3,
                    int keys = kKeys) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  if (n1 == 1) s1 = (d + 7) / 8 * 8;
  if (n2 == 1) s2 = s1 * n1;
  if (n3 == 1) s3 = s2 * n2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n1, (cuuint64_t)n2,
                              (cuuint64_t)n3};
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2,
                                 (cuuint64_t)s3 * 2};
  const cuuint32_t box[4] = {kPanel, (cuuint32_t)keys, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// f(PK, NV) with the panel counts as std::integral_constant, for template
// dispatch: pk, pv in 1 .. 4.
template <typename F>
inline int with_panels(int pk, int pv, F f) {
  auto by_pv = [&](auto PK) -> int {
    switch (pv) {
      case 1: return f(PK, std::integral_constant<int, 1>{});
      case 2: return f(PK, std::integral_constant<int, 2>{});
      case 3: return f(PK, std::integral_constant<int, 3>{});
      default: return f(PK, std::integral_constant<int, 4>{});
    }
  };
  switch (pk) {
    case 1: return by_pv(std::integral_constant<int, 1>{});
    case 2: return by_pv(std::integral_constant<int, 2>{});
    case 3: return by_pv(std::integral_constant<int, 3>{});
    default: return by_pv(std::integral_constant<int, 4>{});
  }
}

}  // namespace tc
}  // namespace repro
