// The 16-byte load, the rounding store and the masked score shared by the
// CUDA-core kernels (attention_common.cuh, decode_common.cuh, ssd_scan.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // a masked score, as the Pallas kernels

// Four float32 values from a 16-byte aligned address.
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, as astype does
}

}  // namespace repro
