// ssd_scan for Hopper (sm_90a): the Mamba2 SSD chunked scan, the
// attention-free layer's sequence mixer in the full-sequence forward (the
// Preprocessor's reference forward).
//
// Replaces the Pallas kernel `ssd_scan` (_ssd_kernel) of
// src/repro/kernels/ssd_scan.py.
//
// What it computes, per (row b, head h) and chunk of Q tokens, with
// A_cum the inclusive prefix sum of dt * A over the chunk:
//   scores[i][j] = (C_i . B_j) * exp(A_cum[i] - A_cum[j])  for i >= j, else 0
//   y            = scores (dt x) + exp(A_cum) * (C state)
//   state        = exp(A_cum[Q-1]) state + B^T (exp(A_cum[Q-1] - A_cum) dt x)
// with the (N, P) state carried in float32 from chunk to chunk, starting at
// zero. Head h reads group h / (H / G) of B and C. y is written in x's
// dtype, the final state as (b, h, n, p) float32.
//
// What bounds it on the H100: the bytes. Each token of each head reads
// P values of x and one dt, each token of each group N values of B and C,
// and writes P values of y: ~97 MB at mamba2-2.7b's train shape (4 x 1024
// tokens, 80 heads of 64, state 128), 29 us at 3.35 TB/s; its ~1.5e10
// operations (the causal triangle of the two intra-chunk products) would
// take 15 us at the bf16 tensor-core rate.
//
// Design (simple on purpose, like the attention kernels): one 256-thread
// block per (head, row) walks the row's chunks in order, the sequential
// chunk axis of the Pallas grid becoming a loop inside the block. The
// state lives in shared memory for the whole loop (32 KB at N 128, P 64),
// beside the chunk's B, C, dt*x and scores, all widened to float32 as
// they are loaded (~130 KB at Q 64). The four chunk products are plain
// FMA loops on CUDA cores over shared memory; B's rows are padded by one
// float so a warp reading 32 rows at one column hits 32 banks. Scores
// above the diagonal are 0 by selection, never exp(positive) * 0, which
// would overflow to inf * 0 = NaN. x, B and C are read through their
// strides, so the model's views of one conv output need no copy. No
// tensor cores, no copy/compute overlap: wgmma and TMA come later.
#include "attention_common.cuh"

namespace repro {

struct SsdStrides {
  long long x[3];   // x (b, l, h, :)
  long long dt[3];  // dt (b, l, h)
  long long b[3];   // B (b, l, g, :)
  long long c[3];   // C (b, l, g, :)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// sum_k a[k * sa] * b[k * sb] over k < len, in four interleaved partial
// sums: rounding chains a quarter as long as one running sum (the sums of
// the scan cancel: at mamba2's widths |y| reaches ~400 where some entries
// are ~1), and four independent FMAs in flight.
__device__ __forceinline__ float dot4(const float* a, int sa, const float* b,
                                      int sb, int len) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 4 <= len; k += 4) {
    s0 = fmaf(a[k * sa], b[k * sb], s0);
    s1 = fmaf(a[(k + 1) * sa], b[(k + 1) * sb], s1);
    s2 = fmaf(a[(k + 2) * sa], b[(k + 2) * sb], s2);
    s3 = fmaf(a[(k + 3) * sa], b[(k + 3) * sb], s3);
  }
  for (; k < len; ++k) s0 = fmaf(a[k * sa], b[k * sb], s0);
  return (s0 + s1) + (s2 + s3);
}

inline size_t ssd_smem_bytes(int Q, int P, int N) {
  const size_t floats = (size_t)N * P + (size_t)Q * (N + 1) + (size_t)Q * N +
                        (size_t)Q * P + (size_t)Q * Q + 4 * (size_t)Q;
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int L, int H, int P, int G,
                int N, int Q, SsdStrides s) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NB = N + 1;
  float* st = smem;             // [N][P]   the carried state
  float* sb = st + N * P;       // [Q][N+1] B, then B * wdec
  float* sc = sb + Q * NB;      // [Q][N]   C
  float* sx = sc + Q * N;       // [Q][P]   dt * x
  float* ss = sx + Q * P;       // [Q][Q]   scores
  float* sdt = ss + Q * Q;      // [Q]      dt
  float* acum = sdt + Q;        // [Q]      inclusive prefix sum of dt * A
  float* eac = acum + Q;        // [Q]      exp(acum)
  float* wdec = eac + Q;        // [Q]      exp(acum[Q-1] - acum)

  const float a = A[h];
  for (int e = tid; e < N * P; e += nt) st[e] = 0.f;

  const T* xb = x + b * s.x[0] + h * s.x[2];
  const float* dtb = dt + b * s.dt[0] + h * s.dt[2];
  const T* bb = Bm + b * s.b[0] + g * s.b[2];
  const T* cb = Cm + b * s.c[0] + g * s.c[2];
  T* yb = y + ((long long)b * L * H + h) * P;  // y is (b, l, h, p) contiguous

  for (int c0 = 0; c0 < L; c0 += Q) {
    // 1. the chunk's dt, B, C and x, widened to float32
    for (int q = tid; q < Q; q += nt)
      sdt[q] = dtb[(long long)(c0 + q) * s.dt[1]];
    for (int e = tid; e < Q * N; e += nt) {
      const int q = e / N, n = e % N;
      sb[q * NB + n] = to_f32(bb[(long long)(c0 + q) * s.b[1] + n]);
      sc[e] = to_f32(cb[(long long)(c0 + q) * s.c[1] + n]);
    }
    for (int e = tid; e < Q * P; e += nt) {
      const int q = e / P, p = e % P;
      sx[e] = to_f32(xb[(long long)(c0 + q) * s.x[1] + p]);
    }
    __syncthreads();
    // 2. A_cum (one thread: Q adds), and dt folded into x
    if (tid == 0) {
      float run = 0.f;
      for (int q = 0; q < Q; ++q) {
        run += sdt[q] * a;
        acum[q] = run;
      }
    }
    for (int e = tid; e < Q * P; e += nt) sx[e] *= sdt[e / P];
    __syncthreads();
    const float last = acum[Q - 1];
    for (int q = tid; q < Q; q += nt) {
      eac[q] = expf(acum[q]);
      wdec[q] = expf(last - acum[q]);
    }
    // 3. scores: a warp takes consecutive j of one i
    for (int e = tid; e < Q * Q; e += nt) {
      const int i = e / Q, j = e % Q;
      float v = 0.f;
      if (i >= j)
        v = dot4(sc + i * N, 1, sb + j * NB, 1, N) * expf(acum[i] - acum[j]);
      ss[e] = v;
    }
    __syncthreads();
    // 4. y = scores (dt x) + exp(A_cum) (C state): a warp takes
    //    consecutive p of one row i. B is not read here: fold the decay
    //    of step 5 into it meanwhile.
    for (int e = tid; e < Q * P; e += nt) {
      const int i = e / P, p = e % P;
      const float diag = dot4(ss + i * Q, 1, sx + p, P, i + 1);
      const float off = dot4(sc + i * N, 1, st + p, P, N);
      store1(yb + (long long)(c0 + i) * H * P + p, diag + eac[i] * off);
    }
    for (int e = tid; e < Q * N; e += nt)
      sb[(e / N) * NB + e % N] *= wdec[e / N];
    __syncthreads();  // every read of the old state is done
    // 5. state = exp(A_cum[Q-1]) state + (B * decay)^T (dt x)
    const float chunk_decay = expf(last);
    for (int e = tid; e < N * P; e += nt) {
      const int n = e / P, p = e % P;
      st[e] = chunk_decay * st[e] + dot4(sb + n, NB, sx + p, P, Q);
    }
    __syncthreads();  // the next chunk overwrites B, C, x and the scores
  }
  float* so = state_out + ((long long)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += nt) so[e] = st[e];
}

template <typename T>
cudaError_t run_ssd(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, void* y, void* state,
                    int batch, int L, int H, int P, int G, int N, int Q,
                    const SsdStrides& s, void* stream) {
  return launch(ssd_scan_kernel<T>, dim3(H, batch), ssd_smem_bytes(Q, P, N),
                stream, (const T*)x, (const float*)dt, (const float*)A,
                (const T*)B, (const T*)C, (T*)y, (float*)state, L, H, P, G,
                N, Q, s);
}

}  // namespace repro

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. dt and A are float32.
// strides: x (b, l, h), dt (b, l, h), B (b, l, g), C (b, l, g) in elements;
// the last dims of x, B and C are contiguous. Returns the launch's
// cudaError_t.
extern "C" int repro_ssd_scan(int dtype, const void* x, const void* dt,
                              const void* A, const void* B, const void* C,
                              void* y, void* state, int batch, int L, int H,
                              int P, int G, int N, int Q,
                              const long long* strides, void* stream) {
  repro::SsdStrides s;
  for (int i = 0; i < 3; ++i) {
    s.x[i] = strides[i];
    s.dt[i] = strides[3 + i];
    s.b[i] = strides[6 + i];
    s.c[i] = strides[9 + i];
  }
  if (dtype == 0)
    return repro::run_ssd<float>(x, dt, A, B, C, y, state, batch, L, H, P, G,
                                 N, Q, s, stream);
  if (dtype == 1)
    return repro::run_ssd<__nv_bfloat16>(x, dt, A, B, C, y, state, batch, L,
                                         H, P, G, N, Q, s, stream);
  return (int)cudaErrorInvalidValue;
}
