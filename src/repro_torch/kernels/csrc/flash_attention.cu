// flash_attention for Hopper (sm_90a): full-sequence causal GQA forward,
// used when the engine recomputes the KV cache of in-flight sequences
// under new weights (set_weights(recompute_kv=True), the paper's §5.1
// ablation) and by the dense Preprocessor's forward.
//
// Replaces the Pallas kernel `flash_attention` (_flash_kernel) of
// src/repro/kernels/flash_attention.py.
//
// What bounds it on the H100: operations. At S = 1024 a (b, h) pair does
// 4 * D * S * (S + 1) / 2 FLOPs (QK^T and PV over the causal triangle)
// against 4 * S * D elements moved, some 250 FLOPs per element, so the
// bound is the tensor cores' bf16 rate.
//
// Design. bfloat16 runs on the tensor cores (attention_tc.cuh): one block
// per (query tile of 128 rows, head, row b), two consumer warpgroups of 64
// rows doing S = Q K^T and O += P V with wgmma, and a producer warp that
// streams K/V tiles of 64 keys of head h // rep by TMA through a ring of
// shared-memory stages, so loads overlap compute. The blocks with the
// longest key ranges (the last query tiles) are scheduled first. Key tiles
// above the diagonal or before the window are never loaded, a warpgroup
// skips a loaded tile that is masked for all its rows, and only tiles
// crossing the diagonal or the window edge evaluate the mask. Any S: TMA
// fills keys past S with zeros and the causal mask drops them, and rows
// past S are not stored. q, k and v are read through their strides (the
// (B, S, H, D) projections, transposed), so no copy is made.
//
// float32, the kernels' check dtype, keeps the CUDA-core kernel of
// attention_common.cuh: float32 FMAs from shared memory, far under the
// bound, and exact to the float32 tolerance that TF32 would miss.
//
// `window > 0` adds the sliding-window mask i - j < window, which the
// Pallas kernel lacks and the JAX package computes with its jnp twin.
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace repro {

// float32: the CUDA-core kernel, R query rows per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int rep, int dk, int dv, int window, float scale,
                       int R, long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_ss) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int g = h / rep;
  const int nrows = min(R, S - q0);
  const Smem sm = carve(smem, R, dk, dv);

  const T* qb = q + b * q_sb + h * q_sh;
  load_rows<T>(sm.q, dk, nrows, dk, [&](int i) { return qb + (q0 + i) * q_ss; });
  init_state(sm, R, dv);
  __syncthreads();

  const T* kb = k + b * k_sb + g * k_sh;
  const T* vb = v + b * v_sb + g * v_sh;
  const int hi = q0 + nrows;  // keys past the last row's diagonal: skipped
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = lo; k0 < hi; k0 += kBlockK) {
    const int n = min(kBlockK, hi - k0);
    load_rows<T>(sm.k, dk + 1, n, dk, [&](int j) { return kb + (k0 + j) * k_ss; });
    load_rows<T>(sm.v, dv, n, dv, [&](int j) { return vb + (k0 + j) * v_ss; });
    __syncthreads();
    tile_update(sm, R, dk, dv, k0, n, scale, [&](int i, int j) {
      const int qi = q0 + i;
      return i < nrows && j <= qi && (window <= 0 || qi - j < window);
    });
  }
  T* ob = out + b * o_sb + h * o_sh;
  store_rows<T>(sm, nrows, dv, [&](int i) { return ob + (q0 + i) * o_ss; });
}

cudaError_t run_f32(const float* q, const float* k, const float* v,
                    float* out, int B, int H, int S, int rep, int dk, int dv,
                    int window, float scale, int R, const long long* st,
                    void* stream) {
  const dim3 grid((S + R - 1) / R, H, B);
  return launch(flash_attention_kernel<float>, grid, smem_bytes(R, dk, dv),
                stream, q, k, v, out, S, rep, dk, dv, window, scale, R,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                st[8], st[9], st[10], st[11]);
}

namespace tc {

// bfloat16: the tensor-core kernel. PK, NV: 64-column panels of Dk, Dv.
template <int PK, int NV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const bf16* __restrict__ q, bf16* __restrict__ out, int S,
                   int rep, int dk, int dv, int window, float scale_log2,
                   int stages,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long o_sb, long long o_sh, long long o_ss) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw, PK, NV, stages);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int nrows = min(kRows, S - q0);
  const int hi = q0 + nrows;  // keys past the last row's diagonal: skipped
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int ntiles = (hi - lo + kKeys - 1) / kKeys;

  const bf16* qb = q + b * q_sb + h * q_sh;
  setup(sm, dk, PK, nrows, stages,
        [&](int i) { return qb + (q0 + i) * q_ss; });

  if (threadIdx.x >= 32 * kConsumerWarps) {
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce(sm, (PK + NV) * kPanelBytes, stages, ntiles,
              [&](int t, uint32_t k_dst, uint32_t v_dst, uint32_t bar) {
                const int k0 = lo + t * kKeys;
                for (int p = 0; p < PK; ++p)
                  tma_load(k_dst + p * kPanelBytes, &tk, bar, p * kPanel, k0,
                           g, b);
                for (int p = 0; p < NV; ++p)
                  tma_load(v_dst + p * kPanelBytes, &tv, bar, p * kPanel, k0,
                           g, b);
              });
    return;
  }

  consumer_regs();
  Consumer<PK, NV> c;
  c.init();
  // the warpgroup's rows, and this thread's two
  const int r_lo = q0 + c.wg * 64, r_hi = r_lo + 63;
  const int qi0 = q0 + c.row(), qi1 = qi0 + 8;
  const bool idle = r_lo >= hi;  // every row of the warpgroup is past S
  c.run(
      sm, ntiles, stages, scale_log2,
      [&](int t) {
        const int k0 = lo + t * kKeys;
        if (idle || k0 > r_hi ||
            (window > 0 && r_lo - (k0 + kKeys - 1) >= window))
          return 0;
        return k0 + kKeys - 1 <= r_lo && (window <= 0 || r_hi - k0 < window)
                   ? 1 : 2;
      },
      [&](int t, int i, int jj) {
        const int j = lo + t * kKeys + jj, qi = i ? qi1 : qi0;
        return j <= qi && (window <= 0 || qi - j < window);
      });
  bf16* ob = out + b * o_sb + h * o_sh;
  c.store(nrows, dv, [&](int r) { return ob + (q0 + r) * o_ss; });
}

template <int PK, int NV>
int run(const void* q, const void* k, const void* v, void* out, int B, int H,
        int S, int rep, int dk, int dv, int window, float scale,
        const long long* st, void* stream) {
  const int KV = H / rep;
  CUtensorMap tk, tv;
  int err = make_map(&tk, k, dk, S, KV, B, st[5], st[4], st[3]);
  if (err) return err;
  err = make_map(&tv, v, dv, S, KV, B, st[8], st[7], st[6]);
  if (err) return err;
  const Geometry geo = geometry(dk, dv);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  return launch(flash_attention_tc<PK, NV>, grid, geo.smem, stream, tk, tv,
                (const bf16*)q, (bf16*)out, S, rep, dk, dv, window,
                scale * kLog2e, geo.stages, st[0], st[1], st[2], st[9],
                st[10], st[11]);
}

}  // namespace tc
}  // namespace repro

// dtype: 0 = float32 (the CUDA-core kernel, R query rows per block), 1 =
// bfloat16 (the tensor-core kernel; R is not used). strides: 12 element
// strides, in order q (b, h, s), k (b, kv, s), v (b, kv, s), out (b, h,
// s). bfloat16 takes dk and dv multiples of 16 up to 256 and 16-byte
// aligned rows (kernels/ops.py checks). Returns the launch's cudaError_t,
// or tc::kMapError + a CUresult when a tensor map cannot be encoded.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int S, int rep, int dk, int dv,
                                     int window, float scale, int R,
                                     const long long* strides, void* stream) {
  using namespace repro;
  if (dtype == 0)
    return (int)run_f32((const float*)q, (const float*)k, (const float*)v,
                        (float*)out, B, H, S, rep, dk, dv, window, scale, R,
                        strides, stream);
  if (dtype != 1 || dk % 16 || dv % 16 || dk > tc::kMaxDim ||
      dv > tc::kMaxDim || dk <= 0 || dv <= 0)
    return (int)cudaErrorInvalidValue;
  // PK, NV: 64-column panels of dk, dv; TMA fills the columns past them
  // with zeros
  return tc::with_panels(
      (dk + tc::kPanel - 1) / tc::kPanel, (dv + tc::kPanel - 1) / tc::kPanel,
      [&](auto PK, auto NV) {
        return tc::run<decltype(PK)::value, decltype(NV)::value>(
            q, k, v, out, B, H, S, rep, dk, dv, window, scale, strides,
            stream);
      });
}
