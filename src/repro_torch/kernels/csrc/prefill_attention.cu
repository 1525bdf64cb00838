// prefill_attention for Hopper (sm_90a): a C-token prompt chunk attending
// to the slot cache's prefix (ring rule) and then causally to its own K/V,
// the generation engine's chunked-prefill admission path.
//
// Replaces the Pallas kernel `prefill_attention` (_prefill_kernel) of
// src/repro/kernels/prefill_attention.py.
//
// What bounds it on the H100: in the cache-prefix pass, the bytes of K/V
// read. A block serves R query rows of one KV head, so it does 2 * R * D
// FLOPs per key against 2 * D elements, and the whole grid reads the
// valid prefix once per query tile.
//
// Design: one block per (query tile of R flattened (chunk position, rep)
// rows, KV head, row b); the rows of a tile share every K/V tile. The
// cache pass loops only over slots below min(offset, CL), the write
// frontier (the Pallas version needed a static grid hint for that), with
// the floor-mod ring rule as the mask; the chunk pass loops only up to the
// tile's last causal key. Caches are read in place through their strides:
// no transposed copy. Dk and Dv are separate so that MLA's absorbed
// prefill (KV = 1, Dk != Dv) can reuse the kernel.
#include "attention_common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const T* __restrict__ kh,
    const T* __restrict__ vh, T* __restrict__ out, int C, int rep, int CL,
    int dk, int dv, int offset, float scale, int R, long long q_sb,
    long long q_sc, long long q_sh, long long kc_sb, long long kc_ss,
    long long kc_sh, long long vc_sb, long long vc_ss, long long vc_sh,
    long long kh_sb, long long kh_ss, long long kh_sh, long long vh_sb,
    long long vh_ss, long long vh_sh, long long o_sb, long long o_sc,
    long long o_sh) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * R, g = blockIdx.y, b = blockIdx.z;
  const int nrows = min(R, C * rep - row0);
  const Smem sm = carve(smem, R, dk, dv);
  // flattened row = ci * rep + r: chunk position ci, query head g * rep + r
  auto head = [&](int i) { return g * rep + (row0 + i) % rep; };
  auto pos = [&](int i) { return (row0 + i) / rep; };

  load_rows<T>(sm.q, dk, nrows, dk, [&](int i) {
    return q + b * q_sb + pos(i) * q_sc + head(i) * q_sh;
  });
  init_state(sm, R, dv);
  __syncthreads();

  // ---- the cache prefix, up to the write frontier
  const int n_cache = min(offset, CL);
  const T* kcb = kc + b * kc_sb + g * kc_sh;
  const T* vcb = vc + b * vc_sb + g * vc_sh;
  for (int k0 = 0; k0 < n_cache; k0 += kBlockK) {
    const int n = min(kBlockK, n_cache - k0);
    load_rows<T>(sm.k, dk + 1, n, dk, [&](int j) { return kcb + (k0 + j) * kc_ss; });
    load_rows<T>(sm.v, dv, n, dv, [&](int j) { return vcb + (k0 + j) * vc_ss; });
    __syncthreads();
    tile_update(sm, R, dk, dv, k0, n, scale, [&](int i, int j) {
      if (i >= nrows) return false;
      // slot j holds absolute position p_j (ring addressing); for a
      // full-length cache this is p_j = j, valid iff j < offset
      const int p_j = (offset - 1) - floor_mod(offset - 1 - j, CL);
      return p_j >= 0 && (offset + pos(i)) - p_j < CL;
    });
  }

  // ---- the chunk's own K/V, causal
  const int n_chunk = nrows > 0 ? pos(nrows - 1) + 1 : 0;
  const T* khb = kh + b * kh_sb + g * kh_sh;
  const T* vhb = vh + b * vh_sb + g * vh_sh;
  for (int k0 = 0; k0 < n_chunk; k0 += kBlockK) {
    const int n = min(kBlockK, n_chunk - k0);
    load_rows<T>(sm.k, dk + 1, n, dk, [&](int j) { return khb + (k0 + j) * kh_ss; });
    load_rows<T>(sm.v, dv, n, dv, [&](int j) { return vhb + (k0 + j) * vh_ss; });
    __syncthreads();
    tile_update(sm, R, dk, dv, k0, n, scale,
                [&](int i, int j) { return i < nrows && j <= pos(i); });
  }
  store_rows<T>(sm, nrows, dv, [&](int i) {
    return out + b * o_sb + pos(i) * o_sc + head(i) * o_sh;
  });
}

template <typename T>
cudaError_t run(const void* q, const void* kc, const void* vc,
                const void* kh, const void* vh, void* out, int B, int C,
                int KV, int rep, int CL, int dk, int dv, int offset,
                float scale, int R, const long long* st, void* stream) {
  const dim3 grid((C * rep + R - 1) / R, KV, B);
  return launch(prefill_attention_kernel<T>, grid, smem_bytes(R, dk, dv),
                stream, (const T*)q, (const T*)kc, (const T*)vc,
                (const T*)kh, (const T*)vh, (T*)out, C, rep, CL, dk, dv,
                offset, scale, R, st[0], st[1], st[2], st[3], st[4], st[5],
                st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
                st[14], st[15], st[16], st[17]);
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. strides: 18 element strides, in order
// q (b, c, h), k_cache (b, slot, kv), v_cache (b, slot, kv),
// k_chunk (b, c, kv), v_chunk (b, c, kv), out (b, c, h).
// Returns the launch's cudaError_t.
extern "C" int repro_prefill_attention(
    int dtype, const void* q, const void* kc, const void* vc, const void* kh,
    const void* vh, void* out, int B, int C, int KV, int rep, int CL, int dk,
    int dv, int offset, float scale, int R, const long long* strides,
    void* stream) {
  if (dtype == 0)
    return repro::run<float>(q, kc, vc, kh, vh, out, B, C, KV, rep, CL, dk,
                             dv, offset, scale, R, strides, stream);
  if (dtype == 1)
    return repro::run<__nv_bfloat16>(q, kc, vc, kh, vh, out, B, C, KV, rep,
                                     CL, dk, dv, offset, scale, R, strides,
                                     stream);
  return (int)cudaErrorInvalidValue;
}
