// Shared machinery of the CUDA-core attention kernels, the float32 builds
// of prefill_attention and flash_attention (their bfloat16 builds run on the
// tensor cores, see attention_tc.cuh; the decode kernels have their own
// body, decode_common.cuh): one thread block owns
// R query rows that all read the same KV head, keeps their online-softmax
// state (running max m, denominator l, numerator acc) in shared memory in
// float32, and streams the keys through shared memory in tiles of kb keys
// (kBlockK; prefill_attention's head dims past 256, absorbed MLA's 576 /
// 512, take 16 rows and 32-key tiles to fit a block's shared memory).
//
// Rounding follows the Pallas kernels: q, k and v are widened to float32
// as they are loaded, scores, softmax and the PV product stay in float32,
// masked scores are -1e30, and the output is acc / max(l, 1e-30) rounded
// once to the output type.
//
// Simple on purpose: plain FMA on CUDA cores, synchronous 16-byte loads,
// no tensor cores and no copy/compute overlap.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "load_store.cuh"

namespace repro {

constexpr int kThreads = 256;
constexpr int kBlockK = 64;  // keys per shared-memory tile, by default

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // elements in one 16-byte load
};

// Floor modulus (Python's %, jnp.remainder): C++ % truncates toward zero,
// and the ring rule takes the modulus of negative numbers.
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// Copy rows [0, n) of a row-addressed (n, d) matrix into shared memory,
// widened to float32, row i at dst + i * ld. The wrapper guarantees that
// d % Vec<T>::n == 0 and that every row starts on a 16-byte boundary.
template <typename T, typename RowPtr>
__device__ __forceinline__ void load_rows(float* dst, int ld, int n, int d,
                                          RowPtr row_ptr) {
  constexpr int V = Vec<T>::n;
  const int per_row = d / V;
  for (int idx = threadIdx.x; idx < n * per_row; idx += blockDim.x) {
    const int i = idx / per_row, c = (idx % per_row) * V;
    float tmp[V];
    load16(row_ptr(i) + c, tmp);
#pragma unroll
    for (int u = 0; u < V; ++u) dst[i * ld + c + u] = tmp[u];
  }
}

// ---- shared-memory state of one block --------------------------------------

struct Smem {
  float* q;     // [R][dk]
  float* k;     // [kb][dk + 1]  (+1: conflict-free column reads)
  float* v;     // [kb][dv]
  float* s;     // [R][kb]       scores, then probabilities
  float* acc;   // [R][dv]
  float* m;     // [R]
  float* l;     // [R]
  float* corr;  // [R]
  int kb;       // keys per tile
};

inline size_t smem_bytes(int R, int dk, int dv, int kb = kBlockK) {
  const size_t floats = (size_t)R * dk + (size_t)kb * (dk + 1) +
                        (size_t)kb * dv + (size_t)R * kb + (size_t)R * dv +
                        3 * (size_t)R;
  return floats * sizeof(float);
}

__device__ __forceinline__ Smem carve(float* base, int R, int dk, int dv,
                                      int kb = kBlockK) {
  Smem sm;
  sm.kb = kb;
  sm.q = base;
  sm.k = sm.q + R * dk;
  sm.v = sm.k + kb * (dk + 1);
  sm.s = sm.v + kb * dv;
  sm.acc = sm.s + R * kb;
  sm.m = sm.acc + R * dv;
  sm.l = sm.m + R;
  sm.corr = sm.l + R;
  return sm;
}

__device__ __forceinline__ void init_state(const Smem& sm, int R, int dv) {
  for (int e = threadIdx.x; e < R * dv; e += blockDim.x) sm.acc[e] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
}

// One key tile: keys k0 .. k0+n-1 sit in sm.k / sm.v rows 0 .. n-1.
// valid(r, key) says whether query row r may attend absolute key `key`.
// Ends with a barrier, so the caller may overwrite the tile next.
template <typename Valid>
__device__ __forceinline__ void tile_update(const Smem& sm, int R, int dk,
                                            int dv, int k0, int n,
                                            float scale, Valid valid) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5, kb = sm.kb;
  // scores: a warp takes 32 consecutive keys of one row
  for (int e = tid; e < R * kb; e += blockDim.x) {
    const int r = e / kb, j = e % kb;
    float sc = kNegInf;
    if (j < n && valid(r, k0 + j)) {
      const float* qr = sm.q + r * dk;
      const float* kr = sm.k + j * (dk + 1);
      float dot = 0.f;
      for (int d = 0; d < dk; ++d) dot = fmaf(qr[d], kr[d], dot);
      sc = dot * scale;
    }
    sm.s[e] = sc;
  }
  __syncthreads();
  // online softmax: one warp per row
  for (int r = warp; r < R; r += nwarps) {
    float* sr = sm.s + r * kb;
    float mx = kNegInf;
    for (int j = lane; j < kb; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = sm.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < kb; j += 32) {
      const float p = expf(sr[j] - m_new);
      sr[j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float c = expf(m_prev - m_new);
      sm.corr[r] = c;
      sm.l[r] = sm.l[r] * c + sum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();
  // acc = acc * corr + P V: a warp takes 32 consecutive columns of one row
  for (int e = tid; e < R * dv; e += blockDim.x) {
    const int r = e / dv, d = e % dv;
    const float* pr = sm.s + r * kb;
    float a = sm.acc[e] * sm.corr[r];
    for (int j = 0; j < n; ++j) a = fmaf(pr[j], sm.v[j * dv + d], a);
    sm.acc[e] = a;
  }
  __syncthreads();
}

// Write acc / max(l, 1e-30) for rows [0, nrows); out_ptr(r) is row r's start.
template <typename T, typename OutPtr>
__device__ __forceinline__ void store_rows(const Smem& sm, int nrows, int dv,
                                           OutPtr out_ptr) {
  for (int e = threadIdx.x; e < nrows * dv; e += blockDim.x) {
    const int r = e / dv, d = e % dv;
    store1(out_ptr(r) + d, sm.acc[e] / fmaxf(sm.l[r], 1e-30f));
  }
}

// Opt the kernel into `bytes` of dynamic shared memory, then launch it.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, size_t bytes, void* stream,
                          Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace repro
