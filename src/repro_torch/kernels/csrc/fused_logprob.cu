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
// byte moved, far above the card's ridge: the tensor cores' bf16 rate.
//
// Structure, shared by both builds. The Pallas grid runs its vocab axis in
// order on one core and carries the online-logsumexp state (m, s, a, t)
// across it in VMEM. Here:
//  - Forward: one block per (128-row tile, vocab split). The block loops
//    over its split's vocab tiles, keeping (m, s, a, t) per row; the vocab
//    is cut into splits, each writing partial (m, s, a, t), and a second
//    small kernel combines them exactly: M = max m_i, S = sum s_i e^(m_i -
//    M), A likewise, T = sum t_i.
//  - Backward: the dh accumulator is (N, D) and the dW one (D, V); at
//    D = 2048 neither fits a block's 227 KB. So the backward, one entry
//    point like `_fused_bwd_call`, walks the vocab in chunks of Vc
//    columns: one kernel recomputes the chunk's logits and writes its
//    logits gradient dl = g_lp 1[v = t] + p (c0 - g_ent l), p = e^(l -
//    lse), to an (N, Vc) scratch, and two product kernels consume it:
//    dh += dl W_chunk^T (a float32 accumulator across chunks, rounded once
//    at the end) and dW_chunk = h^T dl. The (N, V) gradient never exists
//    whole, only one chunk of it, and each chunk is computed once. With
//    dw_chunks > 1 the dW product runs over row ranges into float32
//    partials that the caller sums, the two-level reduction of
//    `_bwd_dw_chunk_kernel`.
// Rounding follows the Pallas kernels: logits and sums in float32, s
// clamped at 1e-30, lp = t - lse, ent = lse - a / s.
//
// bfloat16, the model's dtype, runs on the tensor cores (namespace flp_tc
// below); float32, the kernels' check dtype, on the CUDA cores (namespace
// flp: exact to the float32 tolerance that TF32 would miss).
//
// The CUDA-core build: one tiled product does all the arithmetic: a block
// of 256 threads computes a 128 x 128 float32 tile of A B in registers (8 x
// 8 per thread), streaming 16-deep slices of A and B through shared
// memory. Operands are addressed through element strides, so the (D, V)
// and (V, D) heads, h and h^T all go through the same code, and no
// transposed or padded copy exists. Rows and columns past the edge load as
// zeros and are never stored. The dl scratch is float32.
#include "tc_common.cuh"

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------
//
// Every product, the logits h W, dh += dl W_chunk^T and dW = h^T dl, is one
// mainloop (`produce` / `consume`): a block of two consumer warpgroups and a
// producer warpgroup (tc_common.cuh) computes a 128 x 128 float32 tile, each
// consumer warpgroup 64 rows of it, as wgmma m64n128k16 over the K depth in
// panels of 64 (one 128-byte swizzle span). The producer's lane 0 streams
// each panel's operand tiles by TMA into a ring of shared-memory stages on
// mbarriers, so the loads of the next panels are in flight while one is
// multiplied. bf16 wgmma reads either operand K-major or MN-major
// (transpose bit), so each operand is read in its own layout and no
// transposed copy exists:
//
//   product         A (M x K)             B (K x N), head (D, V) / tied (V, D)
//   logits h W      h (N, D), K-major     W (k = d, n = v): MN-major / K-major
//   dh += dl W^T    dl (N, Vc), K-major   W (k = v, n = d): K-major / MN-major
//   dW = h^T dl     h^T, MN-major         dl, MN-major
//   (tied: dW^T = dl^T h, A and B swapped, both still MN-major)
//
// A K-major tile is one TMA box of 64 (K) x 128 rows; an MN-major one two
// boxes of 64 (MN) x 64 (K), 8 KB apart (the descriptor's leading byte
// offset), 8-row groups along K 1024 bytes apart. TMA's zero fill covers
// every ragged edge (rows past N, columns past V, depth past D or the
// chunk), so tiles need no masked loads; the epilogues mask their stores.
// TMA needs 16-byte row strides: the wrapper stages a head whose rows are
// not (granite's (2048, 49155)) into ceil8(V) columns, and the maps keep
// the true extents, so the padding is never read.
//
// Epilogues, on the accumulator fragments (thread: rows r, r + 8; 32
// columns of each):
//  - forward: the online (m, s, a, t) of its two rows over its own columns,
//    in base 2; the four threads of a row combine theirs exactly once, at
//    the end of the split, and write the split's partials for the same
//    `combine_kernel` as the CUDA-core build.
//  - dl: the logits gradient in float32, written as two bfloat16 terms,
//    bf16(dl) and bf16(dl - bf16(dl)): a bf16 wgmma takes bf16 operands,
//    and one rounding of dl left the gradients 4.3e-3 to 5.9e-3 (max abs
//    over the largest entry) from the float32-dl plain version against the
//    2e-2 check (tests/test_torch_fused_tc.py), the split 7e-4 to 2.1e-3.
//    The dh and dW products read both terms: a third operand tile in each
//    stage and a second wgmma per k16 step.
//  - dh: adds the float32 accumulator of the earlier chunks, writes it
//    back, or after the last chunk rounds once to bfloat16.
//  - dW: stores the chunk's columns in the head's layout and dtype, or
//    float32 partials over 64-aligned row ranges, masked at V.
namespace flp_tc {

using namespace repro::tc;

constexpr int kTile = 128;             // rows and columns of a block's tile
constexpr int kPanelK = 64;            // K depth of a stage
constexpr int kOpBytes = kTile * 128;  // one operand's 128 x 64 bf16 tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The stage ring of a product. AMN, BMN: A (B) read MN-major; SPLIT: 0, 1
// when A has a second bf16 term, 2 when B has (a third tile per stage).
template <bool AMN, bool BMN, int SPLIT>
struct Gemm {
  static constexpr bool kAMN = AMN, kBMN = BMN;
  static constexpr int kSplit = SPLIT;
  static constexpr int kStageBytes = (SPLIT ? 3 : 2) * kOpBytes;
  static constexpr int kStages = SPLIT ? 4 : 6;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStageBytes + 16 * kStages;
};

// A block's work item: the tile's A rows (ra) and B rows (rb) in their
// maps' MN coordinates, the K coordinates of the first panel in each, and
// the number of 64-deep panels.
struct Item {
  int ra, ka, rb, kb, np;
};

struct Ring {
  uint32_t base, full, empty;
};

// Carve the ring (1024-aligned for the swizzle), then initialise its
// barriers: `full` completes on a stage's TMA bytes, `empty` on one
// arrival from each consumer warp.
template <class G>
__device__ __forceinline__ Ring ring_setup(uint8_t* raw) {
  Ring r;
  const uint32_t b = smem_u32(raw);
  r.base = b + ((1024 - (b & 1023)) & 1023);
  r.full = r.base + G::kStages * G::kStageBytes;
  r.empty = r.full + 8 * G::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// One operand's 64-deep panel at MN row r0, depth k: K-major, one box of 64
// (k) x 128 rows; MN-major, two boxes of 64 (mn) x 64 (k).
template <bool MN>
__device__ __forceinline__ void load_op(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int r0, int k) {
  if (MN) {
    tma_load_2d(dst, map, bar, r0, k);
    tma_load_2d(dst + kOpBytes / 2, map, bar, r0 + 64, k);
  } else {
    tma_load_2d(dst, map, bar, k, r0);
  }
}

// Descriptors of k16 step kk of a panel: A's 64 rows of warpgroup wg, and
// all 128 columns of B.
template <bool MN>
__device__ __forceinline__ uint64_t desc_a(uint32_t a, int wg, int kk) {
  return MN ? desc(a + wg * (kOpBytes / 2) + kk * 2048, kOpBytes / 2, 1024)
            : desc(a + wg * (kOpBytes / 2) + kk * 32, 16, 1024);
}
template <bool MN>
__device__ __forceinline__ uint64_t desc_b(uint32_t b, int kk) {
  return MN ? desc(b + kk * 2048, kOpBytes / 2, 1024)
            : desc(b + kk * 32, 16, 1024);
}

#define FLP_ACC64(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),        \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),        \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),        \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define FLP_D64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B over one k16 step, A and B in shared memory, each K-major or
// (transpose bit) MN-major; accumulate iff `acc`.
template <bool AMN, bool BMN>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLP_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : FLP_ACC64(d)
      : "l"(da), "l"(db), "r"(acc), "n"(AMN ? 1 : 0), "n"(BMN ? 1 : 0));
}

// The producer's loop, run by lane 0 of the producer warpgroup: panel p of
// item it goes to the next stage of the ring once its previous contents
// are released.
template <class G, typename Items>
__device__ __forceinline__ void produce(const Ring& rg, const CUtensorMap* ma,
                                        const CUtensorMap* mb,
                                        const CUtensorMap* mlo, int n_items,
                                        Items items) {
  int s = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_items; ++it) {
    const Item w = items(it);
    for (int p = 0; p < w.np; ++p) {
      mbar_wait(rg.empty + 8 * s, ph ^ 1);
      const uint32_t bar = rg.full + 8 * s;
      const uint32_t dst = rg.base + s * G::kStageBytes;
      mbar_expect_tx(bar, G::kStageBytes);
      const int ka = w.ka + p * kPanelK, kb = w.kb + p * kPanelK;
      load_op<G::kAMN>(dst, ma, bar, w.ra, ka);
      load_op<G::kBMN>(dst + kOpBytes, mb, bar, w.rb, kb);
      if (G::kSplit == 1)
        load_op<G::kAMN>(dst + 2 * kOpBytes, mlo, bar, w.ra, ka);
      if (G::kSplit == 2)
        load_op<G::kBMN>(dst + 2 * kOpBytes, mlo, bar, w.rb, kb);
      if (++s == G::kStages) {
        s = 0;
        ph ^= 1;
      }
    }
  }
}

// A consumer thread's place: warpgroup (broadcast from lane 0, so every
// branch on it around a wgmma is uniform), lane, quad position, and its
// first row within the block's 128 (the second is 8 below).
struct Thr {
  int wg, lane, q, r0;
};

__device__ __forceinline__ Thr thread_place() {
  Thr t;
  t.wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  t.lane = threadIdx.x % 32;
  t.q = t.lane % 4;
  t.r0 = t.wg * 64 + ((threadIdx.x % 128) / 32) * 16 + t.lane / 4;
  return t;
}

__device__ __forceinline__ void release(const Ring& rg, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(rg.empty + 8 * s);
}

// The consumer's loop over the block's items: each item's panels in the
// producer's order, one wgmma group per panel with the previous panel's in
// flight, then epi(it, item, acc) on the finished tile. Accumulator entry
// 4 j + 2 i + c is row r0 + 8 i, column 8 j + 2 q + c of the tile.
template <class G, typename Items, typename Epi>
__device__ __forceinline__ void consume(const Ring& rg, const Thr& th,
                                        float (&acc)[64], int n_items,
                                        Items items, Epi epi) {
  int s = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_items; ++it) {
    const Item w = items(it);
    int prev = 0;
    for (int p = 0; p < w.np; ++p) {
      mbar_wait(rg.full + 8 * s, ph);
      const uint32_t a = rg.base + s * G::kStageBytes;
      const uint32_t b = a + kOpBytes, lo = a + 2 * kOpBytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma128<G::kAMN, G::kBMN>(acc, desc_a<G::kAMN>(a, th.wg, kk),
                                   desc_b<G::kBMN>(b, kk), p > 0 || kk > 0);
        if (G::kSplit == 1)
          wgmma128<G::kAMN, G::kBMN>(acc, desc_a<G::kAMN>(lo, th.wg, kk),
                                     desc_b<G::kBMN>(b, kk), 1);
        if (G::kSplit == 2)
          wgmma128<G::kAMN, G::kBMN>(acc, desc_a<G::kAMN>(a, th.wg, kk),
                                     desc_b<G::kBMN>(lo, kk), 1);
      }
      wg_commit();
      if (p > 0) {
        wg_wait<1>();
        release(rg, prev, th.lane);
      }
      prev = s;
      if (++s == G::kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    wg_wait<0>();
    reg_fence(acc);
    release(rg, prev, th.lane);
    epi(it, w, acc);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Store the pair (x at column n, y at n + 1) of a row at `o`, columns
// `on` apart, masked at column extent `nn`; `pairs`: one 2-element store
// is aligned when both columns are in range.
template <typename T>
__device__ __forceinline__ void store_pair(T* o, long long on, int n, int nn,
                                           bool pairs, float x, float y) {
  if (pairs && n + 1 < nn) {
    put2(o, x, y);
  } else {
    if (n < nn) put(o, x);
    if (n + 1 < nn) put(o + on, y);
  }
}

// ---- forward ---------------------------------------------------------------

// Block (row tile x, vocab split y) over vocab tiles [y * per, (y+1) * per);
// ws: (4, n_split, N) partial m, s, a, t. BMN: the (D, V) head.
template <bool BMN>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap mh,
           const __grid_constant__ CUtensorMap mw,
           const int* __restrict__ tgt, float* __restrict__ ws, int N, int D,
           int V, int per, int n_split) {
  using G = Gemm<false, BMN, 0>;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg = ring_setup<G>(smem_raw);
  const int m0 = blockIdx.x * kTile, split = blockIdx.y;
  const int t_lo = split * per;
  const int n_items = min((V + kTile - 1) / kTile, t_lo + per) - t_lo;
  const int np = (D + kPanelK - 1) / kPanelK;
  auto items = [=](int it) { return Item{m0, 0, (t_lo + it) * kTile, 0, np}; };
  if (threadIdx.x >= 32 * kConsumerWarps) {
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce<G>(rg, &mh, &mw, nullptr, n_items, items);
    return;
  }
  consumer_regs();
  const Thr th = thread_place();
  int tg[2];
  float m[2], s[2], a[2], t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + th.r0 + 8 * i;
    tg[i] = row < N ? tgt[row] : -1;
    m[i] = kNegInf;
    s[i] = a[i] = t[i] = 0.f;
  }
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  consume<G>(rg, th, acc, n_items, items,
             [&](int, const Item& w, float (&c)[64]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l[32], mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int col = w.rb + 8 * j + 2 * th.q + cc;
          const float x = c[4 * j + 2 * i + cc];
          l[2 * j + cc] = col < V ? x : kNegInf;  // pad columns never count
          mx = fmaxf(mx, l[2 * j + cc]);
          if (col == tg[i]) t[i] += x;
        }
      // A thread may see no valid column in a tile (the last one), and
      // its max then stays -1e30: the pad columns take p = 0 by selection
      // and corr subtracts before it scales, since fmaf(m, log2e, -mb) at
      // |m| = 1e30 leaves a residual of ~1e23, not 0.
      const float mn = fmaxf(m[i], mx), mb = mn * kLog2e;
      const float corr = exp2f((m[i] - mn) * kLog2e);
      float ps = 0.f, pa = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p =
            l[e] > kNegInf ? exp2f(fmaf(l[e], kLog2e, -mb)) : 0.f;
        ps += p;
        pa += p * l[e];
      }
      s[i] = s[i] * corr + ps;
      a[i] = a[i] * corr + pa;
      m[i] = mn;
    }
  });
  const long long plane = (long long)n_split * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float M = quad_max(m[i]);
    const float f = exp2f((m[i] - M) * kLog2e);
    const float S = quad_sum(s[i] * f), A = quad_sum(a[i] * f);
    const float T = quad_sum(t[i]);
    const int row = m0 + th.r0 + 8 * i;
    if (th.q == 0 && row < N) {
      const long long o = (long long)split * N + row;
      ws[o] = M;
      ws[plane + o] = S;
      ws[2 * plane + o] = A;
      ws[3 * plane + o] = T;
    }
  }
}

// ---- backward --------------------------------------------------------------

// The logits gradient of vocab columns [v0, v0 + nc): tile (row tile x,
// column tile y), written to hi = bf16(dl) and lo = bf16(dl - hi), (N, nc)
// at row stride ld. BMN: the (D, V) head.
template <bool BMN>
__global__ void __launch_bounds__(kThreads, 1)
dl_kernel(const __grid_constant__ CUtensorMap mh,
          const __grid_constant__ CUtensorMap mw, const int* __restrict__ tgt,
          const float* __restrict__ lse, const float* __restrict__ c0,
          const float* __restrict__ glp, const float* __restrict__ gent,
          bf16* __restrict__ hi, bf16* __restrict__ lo, int N, int D, int v0,
          int nc, long long ld) {
  using G = Gemm<false, BMN, 0>;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg = ring_setup<G>(smem_raw);
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int np = (D + kPanelK - 1) / kPanelK;
  auto items = [=](int) { return Item{m0, 0, v0 + n0, 0, np}; };
  if (threadIdx.x >= 32 * kConsumerWarps) {
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce<G>(rg, &mh, &mw, nullptr, 1, items);
    return;
  }
  consumer_regs();
  const Thr th = thread_place();
  float L2[2], cc0[2], gl[2], ge[2];
  int tt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min(m0 + th.r0 + 8 * i, N - 1);
    L2[i] = lse[row] * kLog2e;
    cc0[i] = c0[row];
    gl[i] = glp[row];
    ge[i] = gent[row];
    tt[i] = tgt[row] - v0;
  }
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  consume<G>(rg, th, acc, 1, items, [&](int, const Item&, float (&c)[64]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + th.r0 + 8 * i;
      if (row >= N) continue;
      bf16* h_row = hi + row * ld;
      bf16* l_row = lo + row * ld;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * th.q;
        float d[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float x = c[4 * j + 2 * i + cc];
          const float p = exp2f(fmaf(x, kLog2e, -L2[i]));
          d[cc] = (col + cc == tt[i] ? gl[i] : 0.f) + p * (cc0[i] - ge[i] * x);
        }
        const __nv_bfloat162 dh2 = __floats2bfloat162_rn(d[0], d[1]);
        const float2 dhf = __bfloat1622float2(dh2);
        store_pair(h_row + col, 1, col, nc, true, dhf.x, dhf.y);
        store_pair(l_row + col, 1, col, nc, true, d[0] - dhf.x, d[1] - dhf.y);
      }
    }
  });
}

// dh (N, D) tile (row tile x, d tile y) += dl_chunk W_chunk^T over the
// chunk's nc columns: A = dl (both terms), B = W as (k = v, n = d), BMN for
// the tied (V, D) head. `add`: the float32 sum of the earlier chunks, or
// null; the result goes to `acc` (float32) or, after the last chunk, to
// `dh` in bfloat16.
template <bool BMN>
__global__ void __launch_bounds__(kThreads, 1)
dh_kernel(const __grid_constant__ CUtensorMap mhi,
          const __grid_constant__ CUtensorMap mw,
          const __grid_constant__ CUtensorMap mlo, const float* add,
          float* acc_out, bf16* dh, int N, int D, int v0, int nc) {
  using G = Gemm<false, BMN, 1>;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg = ring_setup<G>(smem_raw);
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int np = (nc + kPanelK - 1) / kPanelK;
  auto items = [=](int) { return Item{m0, 0, n0, v0, np}; };
  if (threadIdx.x >= 32 * kConsumerWarps) {
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce<G>(rg, &mhi, &mw, &mlo, 1, items);
    return;
  }
  consumer_regs();
  const Thr th = thread_place();
  const bool pairs = D % 2 == 0;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  consume<G>(rg, th, acc, 1, items, [&](int, const Item&, float (&c)[64]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + th.r0 + 8 * i;
      if (row >= N) continue;
      const long long o = (long long)row * D;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int d = n0 + 8 * j + 2 * th.q;
        float x = c[4 * j + 2 * i], y = c[4 * j + 2 * i + 1];
        if (add) {
          if (d < D) x += add[o + d];
          if (d + 1 < D) y += add[o + d + 1];
        }
        if (dh)
          store_pair(dh + o + d, 1, d, D, pairs, x, y);
        else
          store_pair(acc_out + o + d, 1, d, D, pairs, x, y);
      }
    }
  });
}

// dW of one chunk as the product M x N over K = N_rows hidden rows, both
// operands MN-major: SPLIT 2 for the (D, V) head (A = h^T: m = d, B = dl:
// n = v), SPLIT 1 for the tied (V, D) one (A = dl^T: m = v, B = h: n = d).
// Tile (x, y) of part z sums rows [z * rows, (z+1) * rows); element (m, n)
// goes to out + z * pz + m * om + n * on, float32 (`f32`, the partials) or
// bfloat16, masked at (M, Nn).
template <int SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
dw_kernel(const __grid_constant__ CUtensorMap ma,
          const __grid_constant__ CUtensorMap mb,
          const __grid_constant__ CUtensorMap mlo, void* out, int f32, int M,
          int Nn, int K, int rows, long long om, long long on,
          long long pz) {
  using G = Gemm<true, true, SPLIT>;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg = ring_setup<G>(smem_raw);
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int z = blockIdx.z, k0 = z * rows;
  const int np = (min(K - k0, rows) + kPanelK - 1) / kPanelK;
  auto items = [=](int) { return Item{m0, k0, n0, k0, np}; };
  if (threadIdx.x >= 32 * kConsumerWarps) {
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce<G>(rg, &ma, &mb, &mlo, 1, items);
    return;
  }
  consumer_regs();
  const Thr th = thread_place();
  const bool pairs = on == 1 && om % 2 == 0 && pz % 2 == 0;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  consume<G>(rg, th, acc, 1, items, [&](int, const Item&, float (&c)[64]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + th.r0 + 8 * i;
      if (m >= M) continue;
      const long long o = z * pz + m * om;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * th.q;
        const float x = c[4 * j + 2 * i], y = c[4 * j + 2 * i + 1];
        if (f32)
          store_pair((float*)out + o + n * on, on, n, Nn, pairs, x, y);
        else
          store_pair((bf16*)out + o + n * on, on, n, Nn, pairs, x, y);
      }
    }
  });
}

inline dim3 tiles(int M, int N, int Z = 1) {
  return dim3((M + kTile - 1) / kTile, (N + kTile - 1) / kTile, Z);
}

// The head's maps: for the logits (B, (k = d, n = v)) and for the dh
// product (B, (k = v, n = d)). The tied (V, D) head is K-major in the
// first and MN-major in the second, the (D, V) head the other way round.
inline int head_maps(CUtensorMap* logits, CUtensorMap* dh, const void* w,
                     bool tied, int D, int V, long long ld_w) {
  if (tied) {
    int err = make_map_2d(logits, w, D, V, ld_w, 64, kTile);
    return err ? err : (dh ? make_map_2d(dh, w, D, V, ld_w, 64, 64) : 0);
  }
  int err = make_map_2d(logits, w, V, D, ld_w, 64, 64);
  return err ? err : (dh ? make_map_2d(dh, w, V, D, ld_w, 64, kTile) : 0);
}

int fwd(const void* h, const void* w, bool tied, const int* tgt, float* lp,
        float* lse, float* ent, float* ws, int N, int D, int V,
        long long ld_h, long long ld_w, int n_split, void* stream) {
  CUtensorMap mh, mw;
  int err = make_map_2d(&mh, h, D, N, ld_h, 64, kTile);
  if (!err) err = head_maps(&mw, nullptr, w, tied, D, V, ld_w);
  if (err) return err;
  const int n_tiles = (V + kTile - 1) / kTile;
  const int per = (n_tiles + n_split - 1) / n_split;
  n_split = (n_tiles + per - 1) / per;  // no split without a tile
  const dim3 grid((N + kTile - 1) / kTile, n_split);
  err = tied ? launch(fwd_kernel<false>, grid, Gemm<false, false, 0>::kSmem,
                      stream, mh, mw, tgt, ws, N, D, V, per, n_split)
             : launch(fwd_kernel<true>, grid, Gemm<false, true, 0>::kSmem,
                      stream, mh, mw, tgt, ws, N, D, V, per, n_split);
  if (err) return err;
  flp::combine_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      ws, lp, lse, ent, N, n_split);
  return (int)cudaGetLastError();
}

// One pass over the vocab in chunks of `chunk` columns, as the CUDA-core
// `bwd`: per chunk dl (both terms, into hi and lo: dl and dl + N * chunk),
// then dh and dW from it. A null dh or dw skips that product.
int bwd(const void* h, const void* w, bool tied, flp::Rows r, void* dh,
        float* acc, void* dw, bf16* dl, int N, int D, int V, long long ld_h,
        long long ld_w, long long dw_sd, long long dw_sv, int rows,
        int n_parts, long long pz, int chunk, void* stream) {
  CUtensorMap mh128, mh64, mwl, mwh;
  int err = make_map_2d(&mh128, h, D, N, ld_h, 64, kTile);
  if (!err) err = make_map_2d(&mh64, h, D, N, ld_h, 64, 64);
  if (!err) err = head_maps(&mwl, &mwh, w, tied, D, V, ld_w);
  if (err) return err;
  bf16* hi = dl;
  bf16* lo = dl + (long long)N * chunk;
  const bool f32 = n_parts > 1;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int nc = V - v0 < chunk ? V - v0 : chunk;
    CUtensorMap mhi128, mlo128, mhi64, mlo64;
    if ((err = make_map_2d(&mhi128, hi, nc, N, chunk, 64, kTile)) ||
        (err = make_map_2d(&mlo128, lo, nc, N, chunk, 64, kTile)) ||
        (err = make_map_2d(&mhi64, hi, nc, N, chunk, 64, 64)) ||
        (err = make_map_2d(&mlo64, lo, nc, N, chunk, 64, 64)))
      return err;
    err = tied ? launch(dl_kernel<false>, tiles(N, nc),
                        Gemm<false, false, 0>::kSmem, stream, mh128, mwl,
                        r.tgt, r.lse, r.c0, r.glp, r.gent, hi, lo, N, D, v0,
                        nc, (long long)chunk)
               : launch(dl_kernel<true>, tiles(N, nc),
                        Gemm<false, true, 0>::kSmem, stream, mh128, mwl,
                        r.tgt, r.lse, r.c0, r.glp, r.gent, hi, lo, N, D, v0,
                        nc, (long long)chunk);
    if (err) return err;
    if (dh) {
      const bool last = v0 + chunk >= V;
      const float* add = v0 > 0 ? acc : nullptr;
      float* acc_out = last ? nullptr : acc;
      bf16* out = last ? (bf16*)dh : nullptr;
      err = tied ? launch(dh_kernel<true>, tiles(N, D),
                          Gemm<false, true, 1>::kSmem, stream, mhi128, mwh,
                          mlo128, add, acc_out, out, N, D, v0, nc)
                 : launch(dh_kernel<false>, tiles(N, D),
                          Gemm<false, false, 1>::kSmem, stream, mhi128, mwh,
                          mlo128, add, acc_out, out, N, D, v0, nc);
      if (err) return err;
    }
    if (dw) {
      char* base = (char*)dw + v0 * dw_sv * (f32 ? 4 : 2);
      err = tied ? launch(dw_kernel<1>, tiles(nc, D, n_parts),
                          Gemm<true, true, 1>::kSmem, stream, mhi64, mh64,
                          mlo64, (void*)base, (int)f32, nc, D, N, rows, dw_sv,
                          dw_sd, pz)
                 : launch(dw_kernel<2>, tiles(D, nc, n_parts),
                          Gemm<true, true, 2>::kSmem, stream, mh64, mhi64,
                          mlo64, (void*)base, (int)f32, D, nc, N, rows, dw_sd,
                          dw_sv, pz);
      if (err) return err;
    }
  }
  return 0;
}

}  // namespace flp_tc
}  // namespace repro

// float32, the CUDA-core build. strides: 4 element strides, in order hidden
// (n, d), head (d, v); the (V, D) head of a tied model passes its strides
// swapped. targets: (N,) int32. lp, lse, ent: (N,) float32. ws: (4,
// n_split, N) float32 scratch. dtype must be 0 (bfloat16 takes the
// tensor-core entry points below). Each function returns the first failing
// launch's cudaError_t, or 0.
extern "C" int repro_fused_logprob_fwd(int dtype, const void* hidden,
                                       const void* head, const int* targets,
                                       float* lp, float* lse, float* ent,
                                       float* ws, int N, int D, int V,
                                       const long long* strides, int n_split,
                                       void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return repro::flp::fwd<float>(hidden, head, targets, lp, lse, ent, ws, N,
                                D, V, strides, n_split, stream);
}

// dh: (N, D) contiguous output, or null. acc: (N, D) float32 scratch
// (unused when V <= chunk or dh is null). dw: the head gradient in the
// head's layout, element (d, v) at dw + d * dw_sd + v * dw_sv; or, with
// n_parts > 1, partials of `rows` rows each, part z at dw + z *
// part_stride; or null. dl: (N, chunk) float32 scratch.
extern "C" int repro_fused_logprob_bwd(
    int dtype, const void* hidden, const void* head, const int* targets,
    const float* lse, const float* c0, const float* g_lp, const float* g_ent,
    void* dh, float* acc, void* dw, float* dl, int N, int D, int V,
    const long long* strides, long long dw_sd, long long dw_sv, int rows,
    int n_parts, long long part_stride, int chunk, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const repro::flp::Rows r{targets, lse, c0, g_lp, g_ent};
  return repro::flp::bwd<float>(hidden, head, r, dh, acc, dw, dl, N, D, V,
                                strides, dw_sd, dw_sv, rows, n_parts,
                                part_stride, chunk, stream);
}

// bfloat16, the tensor-core build. hidden: (N, D) rows ld_h elements apart;
// head: (D, V), or with `tied` (V, D), rows ld_w apart; both with a
// contiguous inner dim and 16-byte aligned rows (kernels/ops.py stages a
// head that is not). Other arguments as above; n_split is a hint (a split
// without a vocab tile is dropped). Returns a cudaError_t, or tc::kMapError
// + a CUresult when a tensor map cannot be encoded.
extern "C" int repro_fused_logprob_fwd_tc(const void* hidden,
                                          const void* head, int tied,
                                          const int* targets, float* lp,
                                          float* lse, float* ent, float* ws,
                                          int N, int D, int V, long long ld_h,
                                          long long ld_w, int n_split,
                                          void* stream) {
  return repro::flp_tc::fwd(hidden, head, tied != 0, targets, lp, lse, ent,
                            ws, N, D, V, ld_h, ld_w, n_split, stream);
}

// dh: (N, D) contiguous bfloat16 or null; acc: (N, D) float32 scratch
// (unused when V <= chunk); dw: bfloat16 in the head's layout, element (d,
// v) at dw + d * dw_sd + v * dw_sv, or with n_parts > 1 float32 partials of
// `rows` rows each (a multiple of 64), part z at dw + z * part_stride; or
// null. dl: (2, N, chunk) bfloat16 scratch, the two terms of the logits
// gradient.
extern "C" int repro_fused_logprob_bwd_tc(
    const void* hidden, const void* head, int tied, const int* targets,
    const float* lse, const float* c0, const float* g_lp, const float* g_ent,
    void* dh, float* acc, void* dw, void* dl, int N, int D, int V,
    long long ld_h, long long ld_w, long long dw_sd, long long dw_sv,
    int rows, int n_parts, long long part_stride, int chunk, void* stream) {
  if (rows % 64) return (int)cudaErrorInvalidValue;
  const repro::flp::Rows r{targets, lse, c0, g_lp, g_ent};
  return repro::flp_tc::bwd(hidden, head, tied != 0, r, dh, acc, dw,
                            (repro::tc::bf16*)dl, N, D, V, ld_h, ld_w, dw_sd,
                            dw_sv, rows, n_parts, part_stride, chunk, stream);
}
