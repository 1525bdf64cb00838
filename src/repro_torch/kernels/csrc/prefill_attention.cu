// prefill_attention for Hopper (sm_90a): a C-token prompt chunk attending
// to the slot cache's prefix (ring rule) and then causally to its own K/V,
// the generation engine's chunked-prefill admission path.
//
// Replaces the Pallas kernel `prefill_attention` (_prefill_kernel) of
// src/repro/kernels/prefill_attention.py.
//
// What bounds it on the H100: in the cache-prefix pass, the bytes of K/V
// read. A block serves 128 flattened query rows of one KV head, so it does
// 2 * 128 * D FLOPs per key against 2 * D elements, and the grid reads the
// valid prefix once per query tile; at the serving shape the bound is the
// bytes, with the FLOPs close behind (the tensor cores' bf16 rate).
//
// Design. bfloat16 runs on the tensor cores (attention_tc.cuh): one block
// per (query tile of 128 flattened (chunk position, rep) rows, KV head,
// row b), two consumer warpgroups of 64 rows doing S = Q K^T and O += P V
// with wgmma, and a producer warp that streams 64-key K/V tiles by TMA
// through a ring of shared-memory stages, so every row of the tile shares
// each K/V tile and loads overlap compute. The cache pass streams only
// slots below min(offset, CL), the write frontier, with the floor-mod ring
// rule as the mask; the chunk pass streams up to the tile's last causal
// key. Tiles wholly inside the mask skip it, and a warpgroup skips a tile
// masked for all its rows. Caches and chunk K/V are read in place through
// their strides by the tensor maps: no copy. Dk and Dv are separate so that
// MLA's absorbed prefill (KV = 1, Dk != Dv) can reuse the kernel.
//
// Absorbed MLA at DeepSeek-V3's widths (KV = 1, Dk = 512 + 64, Dv = 512,
// 128 query heads) takes the wide instance (`prefill_attention_wide`, head
// dims past 256): 64 flattened rows a block, both consumer warpgroups on
// those rows, each computing S and the softmax itself and accumulating half
// of O's 512 columns, 32-key tiles in two stages (attention_tc.cuh). At the
// engine's chunk (C 64, offset 320, 128 heads) a block's 64 rows are one
// chunk position of 64 heads, so the chunk pass is one or two tiles and the
// cache pass ten. S is 53% of each warpgroup's tensor-core work (PV, in
// two bf16 terms, the rest); the second warpgroup's copy of it, a quarter
// of the block's, is the price of passing nothing between them.
//
// float32, the kernels' check dtype, keeps the CUDA-core kernel of
// attention_common.cuh (float32 FMAs from shared memory): TF32 would miss
// its tolerance. Where 32 rows and 64-key tiles do not fit a block's shared
// memory (absorbed MLA's 576 / 512 need 427 KB), it takes 16 rows and
// 32-key tiles (211 KB); kernels/ops.py `_prefill_geometry` chooses.
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace repro {

// float32: the CUDA-core kernel, R flattened rows per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const T* __restrict__ kh,
    const T* __restrict__ vh, T* __restrict__ out, int C, int rep, int CL,
    int dk, int dv, int offset, float scale, int R, int kb, long long q_sb,
    long long q_sc, long long q_sh, long long kc_sb, long long kc_ss,
    long long kc_sh, long long vc_sb, long long vc_ss, long long vc_sh,
    long long kh_sb, long long kh_ss, long long kh_sh, long long vh_sb,
    long long vh_ss, long long vh_sh, long long o_sb, long long o_sc,
    long long o_sh) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * R, g = blockIdx.y, b = blockIdx.z;
  const int nrows = min(R, C * rep - row0);
  const Smem sm = carve(smem, R, dk, dv, kb);
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
  for (int k0 = 0; k0 < n_cache; k0 += kb) {
    const int n = min(kb, n_cache - k0);
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
  for (int k0 = 0; k0 < n_chunk; k0 += kb) {
    const int n = min(kb, n_chunk - k0);
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

cudaError_t run_f32(const float* q, const float* kc, const float* vc,
                    const float* kh, const float* vh, float* out, int B,
                    int C, int KV, int rep, int CL, int dk, int dv,
                    int offset, float scale, int R, int kb,
                    const long long* st, void* stream) {
  const dim3 grid((C * rep + R - 1) / R, KV, B);
  return launch(prefill_attention_kernel<float>, grid,
                smem_bytes(R, dk, dv, kb), stream, q, kc, vc, kh, vh, out, C,
                rep, CL, dk, dv, offset, scale, R, kb, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                st[15], st[16], st[17]);
}

namespace tc {

// The mask of a warpgroup's rows, chunk positions pmin .. pmax, for the
// consumers' `run`: kind(t) of tile t of `keys` keys, the cache's tiles
// first (t < t_cache), then the chunk's; valid(t, p, jj) of key jj for a
// query at chunk position p. Slot j holds absolute position p_j (ring
// addressing); for a cache that has not wrapped (offset <= CL), p_j = j,
// valid iff j < offset and the query is less than CL positions ahead.
struct PrefillMask {
  int offset, CL, n_cache, t_cache, keys, pmin, pmax;
  bool idle;  // every row of the warpgroup is past the block's

  __device__ __forceinline__ int kind(int t) const {
    if (idle) return 0;
    const bool flat = offset <= CL;
    if (t < t_cache) {
      const int k0 = t * keys;
      if (flat && offset + pmin - (k0 + keys - 1) >= CL) return 0;
      return flat && k0 + keys <= n_cache && offset + pmax - k0 < CL ? 1
                                                                        : 2;
    }
    const int k0 = (t - t_cache) * keys;
    return k0 > pmax ? 0 : k0 + keys - 1 <= pmin ? 1 : 2;
  }

  __device__ __forceinline__ bool valid(int t, int p, int jj) const {
    if (t >= t_cache) return (t - t_cache) * keys + jj <= p;
    const int j = t * keys + jj;
    const int p_j = (offset - 1) - floor_mod(offset - 1 - j, CL);
    return j < n_cache && p_j >= 0 && offset + p - p_j < CL;
  }
};

// bfloat16: the tensor-core kernel. PK, NV: 64-column panels of Dk, Dv.
template <int PK, int NV>
__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_tc(const __grid_constant__ CUtensorMap tkc,
                     const __grid_constant__ CUtensorMap tvc,
                     const __grid_constant__ CUtensorMap tkh,
                     const __grid_constant__ CUtensorMap tvh,
                     const bf16* __restrict__ q, bf16* __restrict__ out,
                     int C, int rep, int CL, int dk, int dv, int offset,
                     float scale_log2, int stages, long long q_sb,
                     long long q_sc, long long q_sh, long long o_sb,
                     long long o_sc, long long o_sh) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw, PK, NV, stages);
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int g = blockIdx.y, b = blockIdx.z;
  const int nrows = min(kRows, C * rep - row0);
  // flattened row = ci * rep + r: chunk position ci, query head g * rep + r
  auto pos = [&](int i) { return (row0 + i) / rep; };
  auto head = [&](int i) { return g * rep + (row0 + i) % rep; };
  const int n_cache = min(offset, CL);  // slots below the write frontier
  const int n_chunk = pos(nrows - 1) + 1;
  const int t_cache = (n_cache + kKeys - 1) / kKeys;
  const int ntiles = t_cache + (n_chunk + kKeys - 1) / kKeys;

  setup(sm, dk, PK, nrows, stages, [&](int i) {
    return q + b * q_sb + pos(i) * q_sc + head(i) * q_sh;
  });

  if (threadIdx.x >= 32 * kConsumerWarps) {
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce(sm, (PK + NV) * kPanelBytes, stages, ntiles,
              [&](int t, uint32_t k_dst, uint32_t v_dst, uint32_t bar) {
                const bool cache = t < t_cache;
                const int k0 = (cache ? t : t - t_cache) * kKeys;
                const CUtensorMap* km = cache ? &tkc : &tkh;
                const CUtensorMap* vm = cache ? &tvc : &tvh;
                for (int p = 0; p < PK; ++p)
                  tma_load(k_dst + p * kPanelBytes, km, bar, p * kPanel, k0,
                           g, b);
                for (int p = 0; p < NV; ++p)
                  tma_load(v_dst + p * kPanelBytes, vm, bar, p * kPanel, k0,
                           g, b);
              });
    return;
  }

  consumer_regs();
  Consumer<PK, NV> c;
  c.init();
  // the warpgroup's chunk positions, and this thread's two rows'
  const int w0 = c.wg * 64;
  const PrefillMask mask{offset, CL, n_cache, t_cache, kKeys, pos(w0),
                         pos(min(w0 + 63, nrows - 1)), w0 >= nrows};
  const int pos0 = pos(c.row()), pos1 = pos(c.row() + 8);
  c.run(sm, ntiles, stages, scale_log2,
        [&](int t) { return mask.kind(t); },
        [&](int t, int i, int jj) {
          return mask.valid(t, i ? pos1 : pos0, jj);
        });
  c.store(nrows, dv, [&](int r) {
    return out + b * o_sb + pos(r) * o_sc + head(r) * o_sh;
  });
}

// bfloat16 head dims past kMaxDim (Dk up to 576, Dv up to 512): the wide
// instance, one block per (64 flattened rows, KV head, row b), both
// consumer warpgroups on all 64 rows. The ring's panels past dk and dv are
// never loaded: they are zeroed once, so that S and O read zeros there.
__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_wide(const __grid_constant__ CUtensorMap tkc,
                       const __grid_constant__ CUtensorMap tvc,
                       const __grid_constant__ CUtensorMap tkh,
                       const __grid_constant__ CUtensorMap tvh,
                       const bf16* __restrict__ q, bf16* __restrict__ out,
                       int C, int rep, int CL, int dk, int dv, int offset,
                       float scale_log2, int stages, long long q_sb,
                       long long q_sc, long long q_sh, long long o_sb,
                       long long o_sc, long long o_sh) {
  constexpr int kPanelB = kWideKeys * 128;  // a 32 x 64 K or V panel
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw, kWidePK, 2 * kWideNV, stages, kWideRows,
                        kWideKeys);
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kWideRows;
  const int g = blockIdx.y, b = blockIdx.z;
  const int nrows = min(kWideRows, C * rep - row0);
  auto pos = [&](int i) { return (row0 + i) / rep; };
  auto head = [&](int i) { return g * rep + (row0 + i) % rep; };
  const int n_cache = min(offset, CL);
  const int n_chunk = pos(nrows - 1) + 1;
  const int t_cache = (n_cache + kWideKeys - 1) / kWideKeys;
  const int ntiles = t_cache + (n_chunk + kWideKeys - 1) / kWideKeys;
  const int pk = (dk + kPanel - 1) / kPanel, pv = (dv + kPanel - 1) / kPanel;

  for (int s = 0; s < stages; ++s) {
    uint8_t* stage = sm.q_ptr + (sm.ring - sm.q) + s * sm.stage_bytes;
    for (int p = 0; p < kWidePK + 2 * kWideNV; ++p) {
      if (p < kWidePK ? p < pk : p - kWidePK < pv) continue;
      uint4* panel = reinterpret_cast<uint4*>(stage + p * kPanelB);
      for (int i = threadIdx.x; i < kPanelB / 16; i += blockDim.x)
        panel[i] = make_uint4(0, 0, 0, 0);
    }
  }
  setup(sm, dk, kWidePK, nrows, stages, [&](int i) {
    return q + b * q_sb + pos(i) * q_sc + head(i) * q_sh;
  }, kWideRows);

  if (threadIdx.x >= 32 * kConsumerWarps) {
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps)
      produce(sm, (pk + pv) * kPanelB, stages, ntiles,
              [&](int t, uint32_t k_dst, uint32_t v_dst, uint32_t bar) {
                const bool cache = t < t_cache;
                const int k0 = (cache ? t : t - t_cache) * kWideKeys;
                const CUtensorMap* km = cache ? &tkc : &tkh;
                const CUtensorMap* vm = cache ? &tvc : &tvh;
                for (int p = 0; p < pk; ++p)
                  tma_load(k_dst + p * kPanelB, km, bar, p * kPanel, k0, g,
                           b);
                for (int p = 0; p < pv; ++p)
                  tma_load(v_dst + p * kPanelB, vm, bar, p * kPanel, k0, g,
                           b);
              });
    return;
  }

  consumer_regs();
  Consumer<kWidePK, kWideNV, kWideKeys, true> c;
  c.init();
  const PrefillMask mask{offset, CL, n_cache, t_cache, kWideKeys, pos(0),
                         pos(nrows - 1), false};
  const int pos0 = pos(c.row()), pos1 = pos(c.row() + 8);
  c.run(sm, ntiles, stages, scale_log2,
        [&](int t) { return mask.kind(t); },
        [&](int t, int i, int jj) {
          return mask.valid(t, i ? pos1 : pos0, jj);
        });
  c.store(nrows, dv, [&](int r) {
    return out + b * o_sb + pos(r) * o_sc + head(r) * o_sh;
  });
}

template <int PK, int NV>
int run(const void* q, const void* kc, const void* vc, const void* kh,
        const void* vh, void* out, int B, int C, int KV, int rep, int CL,
        int dk, int dv, int offset, float scale, const long long* st,
        void* stream) {
  CUtensorMap tkc, tvc, tkh, tvh;
  int err = make_map(&tkc, kc, dk, CL, KV, B, st[4], st[5], st[3]);
  if (!err) err = make_map(&tvc, vc, dv, CL, KV, B, st[7], st[8], st[6]);
  if (!err) err = make_map(&tkh, kh, dk, C, KV, B, st[10], st[11], st[9]);
  if (!err) err = make_map(&tvh, vh, dv, C, KV, B, st[13], st[14], st[12]);
  if (err) return err;
  const Geometry geo = geometry(dk, dv);
  const dim3 grid((C * rep + kRows - 1) / kRows, KV, B);
  return launch(prefill_attention_tc<PK, NV>, grid, geo.smem, stream, tkc, tvc,
                tkh, tvh, (const bf16*)q, (bf16*)out, C, rep, CL, dk, dv,
                offset, scale * kLog2e, geo.stages, st[0], st[1], st[2],
                st[15], st[16], st[17]);
}

int run_wide(const void* q, const void* kc, const void* vc, const void* kh,
             const void* vh, void* out, int B, int C, int KV, int rep, int CL,
             int dk, int dv, int offset, float scale, const long long* st,
             void* stream) {
  CUtensorMap tkc, tvc, tkh, tvh;
  int err = make_map(&tkc, kc, dk, CL, KV, B, st[4], st[5], st[3], kWideKeys);
  if (!err)
    err = make_map(&tvc, vc, dv, CL, KV, B, st[7], st[8], st[6], kWideKeys);
  if (!err)
    err = make_map(&tkh, kh, dk, C, KV, B, st[10], st[11], st[9], kWideKeys);
  if (!err)
    err = make_map(&tvh, vh, dv, C, KV, B, st[13], st[14], st[12], kWideKeys);
  if (err) return err;
  const Geometry geo = wide_geometry();
  const dim3 grid((C * rep + kWideRows - 1) / kWideRows, KV, B);
  return launch(prefill_attention_wide, grid, geo.smem, stream, tkc, tvc, tkh,
                tvh, (const bf16*)q, (bf16*)out, C, rep, CL, dk, dv, offset,
                scale * kLog2e, geo.stages, st[0], st[1], st[2], st[15],
                st[16], st[17]);
}

}  // namespace tc
}  // namespace repro

// dtype: 0 = float32 (the CUDA-core kernel, R flattened rows per block, kb
// keys per tile), 1 = bfloat16 (the tensor-core kernel; R and kb are not
// used). strides: 18 element strides, in order q (b, c, h), k_cache (b,
// slot, kv), v_cache (b, slot, kv), k_chunk (b, c, kv), v_chunk (b, c,
// kv), out (b, c, h). bfloat16 takes dk and dv multiples of 16 up to 256,
// or past that up to 576 and 512 (the wide instance), and 16-byte aligned
// rows (kernels/ops.py checks). Returns the launch's cudaError_t, or
// tc::kMapError + a CUresult when a tensor map cannot be encoded.
extern "C" int repro_prefill_attention(
    int dtype, const void* q, const void* kc, const void* vc, const void* kh,
    const void* vh, void* out, int B, int C, int KV, int rep, int CL, int dk,
    int dv, int offset, float scale, int R, int kb, const long long* strides,
    void* stream) {
  using namespace repro;
  if (dtype == 0)
    return (int)run_f32((const float*)q, (const float*)kc, (const float*)vc,
                        (const float*)kh, (const float*)vh, (float*)out, B, C,
                        KV, rep, CL, dk, dv, offset, scale, R, kb, strides,
                        stream);
  if (dtype != 1 || dk % 16 || dv % 16 || dk <= 0 || dv <= 0 ||
      dk > tc::kWideMaxDk || dv > tc::kWideMaxDv)
    return (int)cudaErrorInvalidValue;
  if (dk > tc::kMaxDim || dv > tc::kMaxDim)
    return tc::run_wide(q, kc, vc, kh, vh, out, B, C, KV, rep, CL, dk, dv,
                        offset, scale, strides, stream);
  // PK, NV: 64-column panels of dk, dv; TMA fills the columns past them
  // with zeros
  return tc::with_panels(
      (dk + tc::kPanel - 1) / tc::kPanel, (dv + tc::kPanel - 1) / tc::kPanel,
      [&](auto PK, auto NV) {
        return tc::run<decltype(PK)::value, decltype(NV)::value>(
            q, kc, vc, kh, vh, out, B, C, KV, rep, CL, dk, dv, offset, scale,
            strides, stream);
      });
}
