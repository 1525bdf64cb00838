// flash_decode_paged for Hopper (sm_90a): one-token GQA attention read
// straight from the paged KV pool through each row's block table, the
// decode step of a paged generation engine.
//
// Replaces the Pallas kernel `flash_decode_paged` (_paged_decode_kernel) of
// src/repro/kernels/paged_cache.py.
//
// The kernel is flash_decode's split-KV body (decode_common.cuh: what
// bounds it, bytes of K and V, and the design) with one change, the
// address of a key. A block loads the slice of its row's block table that
// covers its split into shared memory once; logical position p is then
// page table[p / PS] at offset p % PS, by a shift and a mask when PS is a
// power of two, resolved per 16-byte copy. So:
//  - the (NP, PS, KV, D) layer slice of the (L, NP, PS, KV, D) pool is read
//    in place through its strides: no transposed copy of the pool (the
//    Pallas wrapper swaps axes 1 and 2 of both pools on every call);
//  - copies stop at lengths[b] (zero-filled past it), so no page past the
//    valid length, the trash page included, is read;
//  - splits, tiles, the online softmax and the merge run in the same order
//    as flash_decode's whatever the page size, so the result equals
//    flash_decode on the gathered slot view bit for bit, for every page
//    size (the Pallas kernel's softmax blocks are pages, bitwise equal to
//    its flash_decode only when page_size == block_k).
#include "decode_common.cuh"

namespace repro {

struct PagedAddr {
  static constexpr bool kTable = true;  // a shared block-table slice
  const int* table;  // shared: entries first .. of the row's block table
  int first, ps, shift;
  long long kp, ko, kh, vp, vo, vh;
  __device__ int block(int p) const {
    return shift >= 0 ? p >> shift : p / ps;
  }
  __device__ PagedAddr(const dec::Params& P, int b, int g, int k0, int k1,
                       int* smem_table)
      : table(smem_table), ps(P.ps), shift(P.ps_shift), kp(P.k_s0),
        ko(P.k_ss), kh(g * P.k_sh), vp(P.v_s0), vo(P.v_ss), vh(g * P.v_sh) {
    first = block(k0);
    const int n = k1 > k0 ? block(k1 - 1) - first + 1 : 0;
    const int* row = P.table + (long long)b * P.nb + first;
    for (int i = threadIdx.x; i < n; i += blockDim.x) smem_table[i] = row[i];
  }
  __device__ __forceinline__ long long k(int p) const {
    const int i = block(p);
    return kh + table[i - first] * kp + (p - i * ps) * ko;
  }
  __device__ __forceinline__ long long v(int p) const {
    const int i = block(p);
    return vh + table[i - first] * vp + (p - i * ps) * vo;
  }
};

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_flash_decode_paged(int dtype,
                                        const repro::dec::Params* p,
                                        void* stream) {
  return repro::dec::run_dtype<repro::PagedAddr>(dtype, p, stream);
}
