// flash_attention for Hopper (sm_90a): full-sequence causal GQA forward,
// used when the engine recomputes the KV cache of in-flight sequences
// under new weights (set_weights(recompute_kv=True), the paper's §5.1
// ablation).
//
// Replaces the Pallas kernel `flash_attention` (_flash_kernel) of
// src/repro/kernels/flash_attention.py.
//
// What bounds it on the H100: operations. At S = 1024 a (b, h) pair does
// 4 * D * S * (S + 1) / 2 FLOPs (QK^T and PV over the causal triangle)
// against 4 * S * D elements moved, some 250 FLOPs per element, so the
// bound is the FLOP rate.
//
// Design: one block per (query tile of R rows, head, row b). The block
// reads K/V of head h // rep and loops over key tiles only up to its last
// row's diagonal, so tiles above the diagonal cost nothing; rows and keys
// past S are never loaded, so any S works (no S % 128 gate). Inputs are
// read through their strides, so (B, S, H, D) projections need no
// transposed copy. This first version computes in float32 on CUDA cores,
// far under the tensor-core rate the bound assumes; wgmma is the next
// step. `window > 0` adds the sliding-window mask i - j < window, which
// the Pallas kernel lacks and the JAX package computes with its jnp twin.
#include "attention_common.cuh"

namespace repro {

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

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                int B, int H, int S, int rep, int dk, int dv, int window,
                float scale, int R, const long long* st, void* stream) {
  const dim3 grid((S + R - 1) / R, H, B);
  return launch(flash_attention_kernel<T>, grid, smem_bytes(R, dk, dv),
                stream, (const T*)q, (const T*)k, (const T*)v, (T*)out, S,
                rep, dk, dv, window, scale, R, st[0], st[1], st[2], st[3],
                st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, in order
// q (b, h, s), k (b, kv, s), v (b, kv, s), out (b, h, s).
// Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int S, int rep, int dk, int dv,
                                     int window, float scale, int R,
                                     const long long* strides, void* stream) {
  if (dtype == 0)
    return repro::run<float>(q, k, v, out, B, H, S, rep, dk, dv, window,
                             scale, R, strides, stream);
  if (dtype == 1)
    return repro::run<__nv_bfloat16>(q, k, v, out, B, H, S, rep, dk, dv,
                                     window, scale, R, strides, stream);
  return (int)cudaErrorInvalidValue;
}
