// flash_decode for Hopper (sm_90a): one-token GQA attention against the
// slot or ring KV cache, the generation engine's per-step hot loop.
//
// Replaces the Pallas kernel `flash_decode` (_decode_kernel) of
// src/repro/kernels/decode_attention.py.
//
// The kernel is the split-KV decode body of decode_common.cuh (what bounds
// it, bytes of K and V, and what the design does about that are noted
// there). This file gives it the slot cache's key address: position p of
// row b's KV head g at b * k_s0 + p * k_ss + g * k_sh, the (B, CL, KV, D)
// layer slice read in place through its strides, no transposed copy.
#include "decode_common.cuh"

namespace repro {

struct SlotAddr {
  static constexpr bool kTable = false;
  long long kb, vb, ks, vs;
  __device__ SlotAddr(const dec::Params& P, int b, int g, int, int, int*)
      : kb(b * P.k_s0 + g * P.k_sh), vb(b * P.v_s0 + g * P.v_sh),
        ks(P.k_ss), vs(P.v_ss) {}
  __device__ __forceinline__ long long k(int p) const { return kb + p * ks; }
  __device__ __forceinline__ long long v(int p) const { return vb + p * vs; }
};

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_flash_decode(int dtype, const repro::dec::Params* p,
                                  void* stream) {
  return repro::dec::run_dtype<repro::SlotAddr>(dtype, p, stream);
}
