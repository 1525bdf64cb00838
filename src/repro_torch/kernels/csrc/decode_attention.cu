// flash_decode for Hopper (sm_90a): one-token GQA attention against the
// slot or ring KV cache, the generation engine's per-step hot loop.
//
// Replaces the Pallas kernel `flash_decode` (_decode_kernel) of
// src/repro/kernels/decode_attention.py.
//
// What bounds it on the H100: the bytes of K/V it reads. Per row b and KV
// head it does 2 * rep * len * D FLOPs per operand against 2 * len * D
// elements read, about rep FLOPs per byte in bf16 (rep = 4 for
// llama3-8b), two orders of magnitude under the card's ridge point.
//
// Design: one block per (KV head, row b). The rep query heads of a KV head
// share every K/V tile, so each cache byte is read once per step; the
// block loops over key tiles only up to lengths[b], so it reads no byte
// past the valid prefix (the Pallas version needed a static grid hint for
// that). It reads the (B, CL, KV, D) layer slice in place through its
// strides: no transposed copy of the cache.
#include "attention_common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int rep, int CL, int dk, int dv,
                    float scale, long long q_sb, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_sh) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x, b = blockIdx.y;
  const Smem sm = carve(smem, rep, dk, dv);
  const int len = max(0, min(lengths[b], CL));

  const T* qb = q + b * q_sb + (long long)g * rep * q_sh;
  load_rows<T>(sm.q, dk, rep, dk, [&](int r) { return qb + r * q_sh; });
  init_state(sm, rep, dv);
  __syncthreads();

  const T* kb = k + b * k_sb + g * k_sh;
  const T* vb = v + b * v_sb + g * v_sh;
  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    const int n = min(kBlockK, len - k0);
    load_rows<T>(sm.k, dk + 1, n, dk, [&](int j) { return kb + (k0 + j) * k_ss; });
    load_rows<T>(sm.v, dv, n, dv, [&](int j) { return vb + (k0 + j) * v_ss; });
    __syncthreads();
    // every loaded key is below lengths[b]: the loop bound is the mask
    tile_update(sm, rep, dk, dv, k0, n, scale, [](int, int) { return true; });
  }
  T* ob = out + b * o_sb + (long long)g * rep * o_sh;
  store_rows<T>(sm, rep, dv, [&](int r) { return ob + r * o_sh; });
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* lengths, void* out, int B, int KV, int rep,
                int CL, int dk, int dv, float scale, long long q_sb,
                long long q_sh, long long k_sb, long long k_ss,
                long long k_sh, long long v_sb, long long v_ss,
                long long v_sh, long long o_sb, long long o_sh,
                void* stream) {
  return launch(flash_decode_kernel<T>, dim3(KV, B), smem_bytes(rep, dk, dv),
                stream, (const T*)q, (const T*)k, (const T*)v,
                (const int*)lengths, (T*)out, rep, CL, dk, dv, scale, q_sb,
                q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh);
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_flash_decode(
    int dtype, const void* q, const void* k, const void* v,
    const void* lengths, void* out, int B, int KV, int rep, int CL, int dk,
    int dv, float scale, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, void* stream) {
  if (dtype == 0)
    return repro::run<float>(q, k, v, lengths, out, B, KV, rep, CL, dk, dv,
                             scale, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                             v_sh, o_sb, o_sh, stream);
  if (dtype == 1)
    return repro::run<__nv_bfloat16>(q, k, v, lengths, out, B, KV, rep, CL,
                                     dk, dv, scale, q_sb, q_sh, k_sb, k_ss,
                                     k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
                                     stream);
  return (int)cudaErrorInvalidValue;
}
