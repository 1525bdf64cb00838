// flash_decode_paged for Hopper (sm_90a): one-token GQA attention read
// straight from the paged KV pool through each row's block table, the
// decode step of a paged generation engine.
//
// Replaces the Pallas kernel `flash_decode_paged` (_paged_decode_kernel) of
// src/repro/kernels/paged_cache.py.
//
// What bounds it on the H100: the bytes of K/V it reads, as for
// flash_decode (decode_attention.cu): about rep FLOPs per byte in bf16, two
// orders of magnitude under the card's ridge point.
//
// Design: flash_decode's kernel with one change, the address of a key.
// One block per (KV head, row b) streams the row's keys through shared
// memory in 64-key tiles up to lengths[b]; logical position p of row b is
// read from page block_tables[b][p / PS] at offset p % PS, resolved per
// key in the row-pointer function of the tile load. So:
//  - the (NP, PS, KV, D) layer slice of the (L, NP, PS, KV, D) pool is
//    read in place through its strides: no transposed copy of the pool
//    (the Pallas wrapper swaps axes 1 and 2 of both pools on every call);
//  - the loop stops at lengths[b], so no grid hint is needed and no page
//    past the valid length (the trash page) is touched;
//  - the tiles and the online softmax run in the same order as
//    flash_decode's whatever the page size, so the result equals
//    flash_decode on the gathered slot view bit for bit, for every page
//    size (the Pallas kernel's softmax blocks are pages, bitwise equal to
//    its flash_decode only when page_size == block_k).
#include "attention_common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ lengths,
                          T* __restrict__ out, int rep, int PS, int NB, int dk,
                          int dv, float scale, long long q_sb, long long q_sh,
                          long long k_sp, long long k_ss, long long k_sh,
                          long long v_sp, long long v_ss, long long v_sh,
                          long long o_sb, long long o_sh) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x, b = blockIdx.y;
  const Smem sm = carve(smem, rep, dk, dv);
  const int len = max(0, min(lengths[b], PS * NB));
  const int* pages = block_tables + (long long)b * NB;

  const T* qb = q + b * q_sb + (long long)g * rep * q_sh;
  load_rows<T>(sm.q, dk, rep, dk, [&](int r) { return qb + r * q_sh; });
  init_state(sm, rep, dv);
  __syncthreads();

  const T* kg = k + g * k_sh;
  const T* vg = v + g * v_sh;
  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    const int n = min(kBlockK, len - k0);
    load_rows<T>(sm.k, dk + 1, n, dk, [&](int j) {
      const int p = k0 + j;
      return kg + pages[p / PS] * k_sp + (p % PS) * k_ss;
    });
    load_rows<T>(sm.v, dv, n, dv, [&](int j) {
      const int p = k0 + j;
      return vg + pages[p / PS] * v_sp + (p % PS) * v_ss;
    });
    __syncthreads();
    // every loaded key is below lengths[b]: the loop bound is the mask
    tile_update(sm, rep, dk, dv, k0, n, scale, [](int, int) { return true; });
  }
  T* ob = out + b * o_sb + (long long)g * rep * o_sh;
  store_rows<T>(sm, rep, dv, [&](int r) { return ob + r * o_sh; });
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* block_tables, const void* lengths, void* out,
                int B, int KV, int rep, int PS, int NB, int dk, int dv,
                float scale, const long long* s, void* stream) {
  return launch(flash_decode_paged_kernel<T>, dim3(KV, B),
                smem_bytes(rep, dk, dv), stream, (const T*)q, (const T*)k,
                (const T*)v, (const int*)block_tables, (const int*)lengths,
                (T*)out, rep, PS, NB, dk, dv, scale, s[0], s[1], s[2], s[3],
                s[4], s[5], s[6], s[7], s[8], s[9]);
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. strides (10, in elements): q (row,
// head), k pool (page, offset, head), v pool (page, offset, head), out (row,
// head). block_tables: (B, NB) int32, row-major. Returns the launch's
// cudaError_t.
extern "C" int repro_flash_decode_paged(
    int dtype, const void* q, const void* k, const void* v,
    const void* block_tables, const void* lengths, void* out, int B, int KV,
    int rep, int PS, int NB, int dk, int dv, float scale,
    const long long* strides, void* stream) {
  if (dtype == 0)
    return repro::run<float>(q, k, v, block_tables, lengths, out, B, KV, rep,
                             PS, NB, dk, dv, scale, strides, stream);
  if (dtype == 1)
    return repro::run<__nv_bfloat16>(q, k, v, block_tables, lengths, out, B,
                                     KV, rep, PS, NB, dk, dv, scale, strides,
                                     stream);
  return (int)cudaErrorInvalidValue;
}
