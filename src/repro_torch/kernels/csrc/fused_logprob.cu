// fused_logprob for Hopper (sm_90a): the trainer's and the Preprocessor's
// lm-head loss. From hidden states h (N, D) and the head W, (D, V) or the
// tied (V, D), it gives per row the target token's logprob, the logsumexp
// and the entropy of softmax(h W), and their gradient with respect to h
// and W, without ever writing the (N, V) logits or their gradient whole.
//
// Replaces the Pallas kernels of src/repro/kernels/fused_logprob.py:
// `_fwd_kernel` (called by `_fused_fwd_call`), and `_bwd_dh_kernel`,
// `_bwd_dw_kernel` and `_bwd_dw_chunk_kernel` (called by `_fused_bwd_call`).
//
// What bounds it on the H100: operations. The forward is one (N, D) x
// (D, V) product, 2 N D V FLOPs against (N + V) D inputs; the backward
// recomputes those logits and does two more products of the same size
// (dh and dW). At N = 4096, D = 2048, V = 49155 that is some 4,000 FLOPs per
// byte moved, far above the card's ridge.
//
// Design. The Pallas grid runs its vocab axis in order on one core and
// carries the online-logsumexp state (m, s, a, t) across it in VMEM. Here:
//  - One tiled product does all the arithmetic: a block of 256 threads
//    computes a 128 x 128 float32 tile of A B in registers (8 x 8 per
//    thread), streaming 16-deep slices of A and B through shared memory,
//    widened to float32 as they are loaded. Operands are addressed through
//    element strides, so the (D, V) and (V, D) heads, h and h^T all go
//    through the same code, and no transposed or padded copy exists. Rows
//    and columns past the edge load as zeros and are never stored: the
//    vocab tail V % 128 is masked here, not padded.
//  - Forward: one block per (128-row tile, vocab split). The block loops
//    over its split's vocab tiles, keeping (m, s, a, t) per row in shared
//    memory; the 16 threads that share a row reduce a tile's columns with
//    warp shuffles. 32 row tiles alone would leave most of the 132 SMs
//    idle, so the vocab is cut into splits, each writing partial
//    (m, s, a, t), and a second small kernel combines them exactly:
//    M = max m_i, S = sum s_i e^(m_i - M), A likewise, T = sum t_i.
//  - Backward: the dh accumulator is (N, D) and the dW one (D, V); at
//    D = 2048 neither fits a block's 227 KB. So the backward, one entry
//    point like `_fused_bwd_call`, walks the vocab in chunks of Vc
//    columns: one kernel recomputes the chunk's logits and writes its
//    logits gradient
//    dl = g_lp 1[v = t] + p (c0 - g_ent l), p = e^(l - lse),
//    to an (N, Vc) float32 scratch buffer, and two product kernels consume
//    it: dh += dl W_chunk^T (float32 accumulator across chunks, rounded
//    once at the end) and dW_chunk = h^T dl. The (N, V) gradient never
//    exists whole, only one chunk of it, and each chunk is computed once. With dw_chunks > 1 the dW product
//    runs over row ranges into float32 partials that the caller sums, the
//    two-level reduction of `_bwd_dw_chunk_kernel`.
// Rounding follows the Pallas kernels: inputs widened to float32, logits
// and sums in float32, s clamped at 1e-30, lp = t - lse, ent = lse - a / s.
// CUDA cores only in this first version; wgmma and TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace flp {

constexpr int kThreads = 256;
constexpr int kTM = 128;       // tile rows
constexpr int kTN = 128;       // tile columns
constexpr int kTK = 16;        // depth of one shared-memory slice
constexpr int kLdA = kTM + 4;  // padded rows of the slices
constexpr int kLdB = kTN + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A matrix operand through its element strides: A (M, K) element (m, k) at
// p + m * sm + k * sk; B (K, N) element (k, n) at p + k * sk + n * sm (for
// B, `sm` is the stride of the output's column index).
template <typename T>
struct Mat {
  const T* p;
  long long sm, sk;
};

// acc[i][j] = sum_{k in [k_lo, k_hi)} A[m0 + 8 ty + i, k] B[k, n0 + 8 tx + j]
// with tx = threadIdx.x % 16, ty = threadIdx.x / 16. Out-of-range rows,
// columns and depths contribute zeros. Ends with a barrier.
template <typename TA, typename TB>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], float* As,
                                             float* Bs, Mat<TA> A, int M,
                                             int m0, Mat<TB> B, int N, int n0,
                                             int k_lo, int k_hi) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = k_lo; k0 < k_hi; k0 += kTK) {
    // neighbouring threads take neighbouring addresses where a stride is 1
    for (int e = tid; e < kTM * kTK; e += kThreads) {
      int m, k;
      if (A.sk == 1) { k = e % kTK; m = e / kTK; }
      else { m = e % kTM; k = e / kTM; }
      const int gm = m0 + m, gk = k0 + k;
      As[k * kLdA + m] =
          (gm < M && gk < k_hi) ? ld(A.p + gm * A.sm + gk * A.sk) : 0.f;
    }
    for (int e = tid; e < kTN * kTK; e += kThreads) {
      int n, k;
      if (B.sm == 1) { n = e % kTN; k = e / kTN; }  // B.sm: the n stride
      else { k = e % kTK; n = e / kTK; }
      const int gn = n0 + n, gk = k0 + k;
      Bs[k * kLdB + n] =
          (gn < N && gk < k_hi) ? ld(B.p + gk * B.sk + gn * B.sm) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * kLdA + 8 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * kLdA + 8 * ty + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kLdB + 8 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * kLdB + 8 * tx + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Sum / max over the 16 threads that share a row (one half of a warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- forward ---------------------------------------------------------------

// Block (row tile x, vocab split y) over vocab tiles [y * per, (y+1) * per).
// ws: (4, n_split, N) partial m, s, a, t.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(Mat<T> H, Mat<T> W, const int* __restrict__ tgt,
           float* __restrict__ ws, int N, int D, int V, int tiles_per_split,
           int n_split) {
  __shared__ __align__(16) float As[kTK * kLdA];
  __shared__ __align__(16) float Bs[kTK * kLdB];
  __shared__ float m_s[kTM], s_s[kTM], a_s[kTM], t_s[kTM];
  __shared__ int tgt_s[kTM];
  const int m0 = blockIdx.x * kTM, split = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int r = tid; r < kTM; r += kThreads) {
    m_s[r] = kNegInf;
    s_s[r] = a_s[r] = t_s[r] = 0.f;
    tgt_s[r] = (m0 + r < N) ? tgt[m0 + r] : -1;
  }
  __syncthreads();
  const int n_tiles = (V + kTN - 1) / kTN;
  const int t_lo = split * tiles_per_split;
  const int t_hi = min(n_tiles, t_lo + tiles_per_split);
  float acc[8][8];
  for (int vt = t_lo; vt < t_hi; ++vt) {
    const int v0 = vt * kTN;
    tile_product<T, T>(acc, As, Bs, H, N, m0, W, V, v0, 0, D);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * ty + i;
      float l[8], mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + 8 * tx + j;
        l[j] = col < V ? acc[i][j] : kNegInf;  // pad columns never count
        mx = fmaxf(mx, l[j]);
      }
      mx = row_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float ps = 0.f, pa = 0.f, pt = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(l[j] - m_new);
        ps += p;
        pa += p * l[j];
        if (v0 + 8 * tx + j == tgt_s[r]) pt += l[j];
      }
      ps = row_sum(ps);
      pa = row_sum(pa);
      pt = row_sum(pt);
      if (tx == 0) {
        const float corr = expf(m_prev - m_new);
        s_s[r] = s_s[r] * corr + ps;
        a_s[r] = a_s[r] * corr + pa;
        t_s[r] += pt;
        m_s[r] = m_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int r = tid; r < kTM; r += kThreads) {
    const int row = m0 + r;
    if (row >= N) continue;
    const long long o = (long long)split * N + row;
    const long long plane = (long long)n_split * N;
    ws[o] = m_s[r];
    ws[plane + o] = s_s[r];
    ws[2 * plane + o] = a_s[r];
    ws[3 * plane + o] = t_s[r];
  }
}

// One thread per row: combine the splits' partials into lp, lse, ent.
__global__ void combine_kernel(const float* __restrict__ ws,
                               float* __restrict__ lp, float* __restrict__ lse,
                               float* __restrict__ ent, int N, int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long long plane = (long long)n_split * N;
  float M = kNegInf;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ws[(long long)i * N + row]);
  float S = 0.f, A = 0.f, Tt = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const long long o = (long long)i * N + row;
    const float c = expf(ws[o] - M);
    S += ws[plane + o] * c;
    A += ws[2 * plane + o] * c;
    Tt += ws[3 * plane + o];
  }
  const float s = fmaxf(S, 1e-30f);
  const float L = M + logf(s);
  lse[row] = L;
  lp[row] = Tt - L;
  ent[row] = L - A / s;
}

// ---- backward --------------------------------------------------------------

// dl (N, nc) of vocab columns [v0, v0 + nc), row stride ld_dl.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dlogits_kernel(Mat<T> H, Mat<T> W, const int* __restrict__ tgt,
               const float* __restrict__ lse, const float* __restrict__ c0,
               const float* __restrict__ glp, const float* __restrict__ gent,
               float* __restrict__ dl, int N, int D, int v0, int nc,
               long long ld_dl) {
  __shared__ __align__(16) float As[kTK * kLdA];
  __shared__ __align__(16) float Bs[kTK * kLdB];
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  Mat<T> Wc = W;
  Wc.p = W.p + (long long)v0 * W.sm;
  float acc[8][8];
  tile_product<T, T>(acc, As, Bs, H, N, m0, Wc, nc, n0, 0, D);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + 8 * ty + i;
    if (row >= N) continue;
    const float L = lse[row], c = c0[row], gl = glp[row], ge = gent[row];
    const int t = tgt[row];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = n0 + 8 * tx + j;
      if (cc >= nc) continue;
      const float l = acc[i][j];
      const float p = expf(l - L);
      const float onehot = (v0 + cc == t) ? 1.f : 0.f;
      dl[row * ld_dl + cc] = gl * onehot + p * (c - ge * l);
    }
  }
}

// out[z] (M, N) = A[:, K-range z] B[K-range z, :] (+ add), K-range z =
// [z * rows, min(K, (z+1) * rows)). Element (m, n) of out[z] sits at
// out + z * oz + m * om + n * on; `add`, when given, has out's strides and
// may be out itself (each element is read, then written, by one thread).
template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
product_kernel(Mat<TA> A, Mat<TB> B, TO* out, const float* add, int M,
               int N, int K, int rows,
               long long om, long long on, long long oz) {
  __shared__ __align__(16) float As[kTK * kLdA];
  __shared__ __align__(16) float Bs[kTK * kLdB];
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN, z = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k_lo = z * rows, k_hi = min(K, k_lo + rows);
  float acc[8][8];
  tile_product<TA, TB>(acc, As, Bs, A, M, m0, B, N, n0, k_lo, k_hi);
  TO* o = out + (long long)z * oz;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 8 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * tx + j;
      if (n >= N) continue;
      const long long e = m * om + n * on;
      store(o + e, add ? add[e] + acc[i][j] : acc[i][j]);
    }
  }
}

inline dim3 tiles(int M, int N, int Z = 1) {
  return dim3((M + kTM - 1) / kTM, (N + kTN - 1) / kTN, Z);
}

// The head as operand B of the logits product h W: (k = d, n = v).
template <typename T>
Mat<T> head_kn(const void* w, long long sd, long long sv) {
  return Mat<T>{(const T*)w, sv, sd};
}

template <typename T>
cudaError_t fwd(const void* h, const void* w, const int* tgt, float* lp,
                float* lse, float* ent, float* ws, int N, int D, int V,
                const long long* st, int n_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Mat<T> H{(const T*)h, st[0], st[1]};
  const Mat<T> W = head_kn<T>(w, st[2], st[3]);
  const int n_tiles = (V + kTN - 1) / kTN;
  const int per = (n_tiles + n_split - 1) / n_split;
  n_split = (n_tiles + per - 1) / per;  // no split without a tile
  fwd_kernel<T><<<dim3((N + kTM - 1) / kTM, n_split), kThreads, 0, s>>>(
      H, W, tgt, ws, N, D, V, per, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(ws, lp, lse, ent, N,
                                                  n_split);
  return cudaGetLastError();
}

struct Rows {
  const int* tgt;
  const float *lse, *c0, *glp, *gent;
};

// One pass over the vocab in chunks of `chunk` columns. Each chunk's
// logits gradient dl (N, nc) is computed once, into the float32 scratch
// `dl` (N, chunk), and feeds both products:
//  - dh (N, D), contiguous, in T: dh += dl W_chunk^T, accumulated in the
//    float32 scratch `acc` (N, D) while chunks remain, rounded once into
//    dh by the last chunk's product;
//  - dw in the head's layout and dtype (dw_sd, dw_sv: strides of d and v):
//    dW_chunk = h^T dl; or, with n_parts > 1, float32 partials (n_parts,
//    ...) at part stride pz, over row ranges of `rows` rows.
// A null dh or dw skips that product.
template <typename T>
cudaError_t bwd(const void* h, const void* w, Rows r, void* dh, float* acc,
                void* dw, float* dl, int N, int D, int V, const long long* st,
                long long dw_sd, long long dw_sv, int rows, int n_parts,
                long long pz, int chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Mat<T> H{(const T*)h, st[0], st[1]};
  const Mat<T> W = head_kn<T>(w, st[2], st[3]);
  cudaError_t err;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int nc = V - v0 < chunk ? V - v0 : chunk;
    dlogits_kernel<T><<<tiles(N, nc), kThreads, 0, s>>>(
        H, W, r.tgt, r.lse, r.c0, r.glp, r.gent, dl, N, D, v0, nc, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (dh) {
      // dh(n, d) += sum_v dl(n, v) W(d, v): A = dl (m = n, k = v),
      // B = the chunk of W as (k = v, n = d)
      const Mat<float> A{dl, chunk, 1};
      const Mat<T> B{(const T*)w + (long long)v0 * st[3], st[2], st[3]};
      const float* add = v0 > 0 ? acc : nullptr;
      if (v0 + chunk >= V)
        product_kernel<float, T, T><<<tiles(N, D), kThreads, 0, s>>>(
            A, B, (T*)dh, add, N, D, nc, nc, D, 1, 0);
      else
        product_kernel<float, T, float><<<tiles(N, D), kThreads, 0, s>>>(
            A, B, acc, add, N, D, nc, nc, D, 1, 0);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (dw) {
      // dW(d, v) = sum_n h(n, d) dl(n, v): A = h^T (m = d, k = n),
      // B = dl (k = n, n = v)
      const Mat<T> A{(const T*)h, st[1], st[0]};
      const Mat<float> B{dl, 1, chunk};
      if (n_parts > 1)
        product_kernel<T, float, float>
            <<<tiles(D, nc, n_parts), kThreads, 0, s>>>(
                A, B, (float*)dw + (long long)v0 * dw_sv, nullptr, D, nc, N,
                rows, dw_sd, dw_sv, pz);
      else
        product_kernel<T, float, T><<<tiles(D, nc), kThreads, 0, s>>>(
            A, B, (T*)dw + (long long)v0 * dw_sv, nullptr, D, nc, N, N,
            dw_sd, dw_sv, 0);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace flp
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (hidden and head share it). strides: 4
// element strides, in order hidden (n, d), head (d, v); the (V, D) head of a
// tied model passes its strides swapped. targets: (N,) int32. lp, lse, ent:
// (N,) float32. ws: (4, n_split, N) float32 scratch. Each function returns
// the first failing launch's cudaError_t, or 0.
extern "C" int repro_fused_logprob_fwd(int dtype, const void* hidden,
                                       const void* head, const int* targets,
                                       float* lp, float* lse, float* ent,
                                       float* ws, int N, int D, int V,
                                       const long long* strides, int n_split,
                                       void* stream) {
  if (dtype == 0)
    return repro::flp::fwd<float>(hidden, head, targets, lp, lse, ent, ws, N,
                                  D, V, strides, n_split, stream);
  if (dtype == 1)
    return repro::flp::fwd<__nv_bfloat16>(hidden, head, targets, lp, lse, ent,
                                          ws, N, D, V, strides, n_split,
                                          stream);
  return (int)cudaErrorInvalidValue;
}

// dh: (N, D) contiguous output in the hidden dtype, or null. acc: (N, D)
// float32 scratch (unused when V <= chunk or dh is null). dw: the head
// gradient in the head's dtype, element (d, v) at dw + d * dw_sd + v *
// dw_sv; or, with n_parts > 1, float32 partials of `rows` rows each, part z
// at dw + z * part_stride; or null. dl: (N, chunk) float32 scratch.
extern "C" int repro_fused_logprob_bwd(
    int dtype, const void* hidden, const void* head, const int* targets,
    const float* lse, const float* c0, const float* g_lp, const float* g_ent,
    void* dh, float* acc, void* dw, float* dl, int N, int D, int V,
    const long long* strides, long long dw_sd, long long dw_sv, int rows,
    int n_parts, long long part_stride, int chunk, void* stream) {
  const repro::flp::Rows r{targets, lse, c0, g_lp, g_ent};
  if (dtype == 0)
    return repro::flp::bwd<float>(hidden, head, r, dh, acc, dw, dl, N, D, V,
                                  strides, dw_sd, dw_sv, rows, n_parts,
                                  part_stride, chunk, stream);
  if (dtype == 1)
    return repro::flp::bwd<__nv_bfloat16>(hidden, head, r, dh, acc, dw, dl,
                                          N, D, V, strides, dw_sd, dw_sv,
                                          rows, n_parts, part_stride, chunk,
                                          stream);
  return (int)cudaErrorInvalidValue;
}
