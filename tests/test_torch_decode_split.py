"""The split-KV decode kernels' partition and merge (`csrc/decode_common.cuh`)
on the CPU, where the CUDA kernels cannot run.

`split_emulation` repeats, in plain float32 torch, what a launch of the
kernels computes: splits of `span` keys, each a block whose warps own
`tile / 4` keys of every tile and keep their own online softmax, the warps
merged in order, then the live splits of a row merged in order 0, 1, ...;
keys at or past a row's length are never read. It is used by nothing on the
main path. The tests hold it against the port's plain `flash_decode_ref` and
the JAX package's Pallas `flash_decode` in interpret mode, with inputs made
from a numpy seed, at the tolerances of `tests/test_torch_kernels.py`:
2e-5 in float32 (sums in another order), 2e-2 in bfloat16. In bfloat16 the
emulation feeds the probabilities to P V as the kernel's mma does, in two
bfloat16 terms bf16(P) and bf16(P - bf16(P)); a test sets that error beside
the error of P rounded once, the rounding of a single mma. A length-0 row
gives zeros in the kernels, the
emulation and the Pallas kernel; the plain version's softmax over only
masked scores gives the mean of V there instead, so that row is checked
against zeros. Also: the emulated slot and paged partitions agree bit for
bit whatever the page size, and the wrappers' geometry
(`ops._decode_geometry`) depends on shapes only, splits the slot and paged
kernels alike, and fits the block's shared memory with two ring stages for
every head dim the kernels take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

WARPS = 4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SMEM_LIMIT = 232448


def _rows(cache, table, page_size, pos, lengths):
    """Rows `pos` (n,) of every batch row's cache, (B, n, KV, D) in float32,
    zero at or past the row's length (nothing there is read): the slot
    cache (B, CL, KV, D) directly, or the pool (NP, PS, KV, D) through the
    block table."""
    B = lengths.shape[0]
    valid = pos[None] < lengths[:, None]                          # (B, n)
    safe = torch.where(valid, pos[None], torch.zeros_like(pos[None]))
    if table is None:
        rows = cache[torch.arange(B)[:, None], safe]
    else:
        pages = table.long()[torch.arange(B)[:, None], safe // page_size]
        rows = cache[pages, safe % page_size]
    return torch.where(valid[..., None, None], rows.float(), 0.0), valid


def _pv(p, vr, terms):
    """P V (b, g, r, d) with P fed in float32 (terms 0), rounded once to
    bfloat16 (1), or as bf16(P) + bf16(P - bf16(P)) (2), summed in float32."""
    if terms == 0:
        return torch.einsum("bgrj,bjgd->bgrd", p, vr)
    hi = p.to(torch.bfloat16).float()
    out = torch.einsum("bgrj,bjgd->bgrd", hi, vr)
    if terms == 2:
        out = out + torch.einsum("bgrj,bjgd->bgrd",
                                 (p - hi).to(torch.bfloat16).float(), vr)
    return out


def split_emulation(q, k, v, lengths, *, scale, span, tile, table=None,
                    page_size=0, p_terms=None, rounded=True):
    """(B, H, Dv), in q's dtype (`rounded`) or float32: the decode kernels'
    partition and merge. k, v: slot caches (B, CL, KV, D), or pools (NP,
    PS, KV, D) with `table` (B, NB) and `page_size`. `p_terms`: how P
    enters P V (`_pv`); by default as the kernel of q's dtype feeds it, two
    bfloat16 terms in bfloat16 and float32 in float32."""
    if p_terms is None:
        p_terms = 2 if q.dtype == torch.bfloat16 else 0
    B, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    keys = k.shape[1] if table is None else table.shape[1] * page_size
    rep, kw = H // KV, tile // WARPS
    qf = q.float().reshape(B, KV, rep, Dk)
    lengths = lengths.long().clamp(0, keys)
    parts = []
    for s in range(-(-keys // span)):
        warps = []
        for w in range(WARPS):
            m = torch.full((B, KV, rep), -1e30)
            l = torch.zeros((B, KV, rep))
            acc = torch.zeros((B, KV, rep, Dv))
            for t in range(-(-span // tile)):
                pos = s * span + t * tile + w * kw + torch.arange(kw)
                pos = pos[pos < min(keys, (s + 1) * span)]
                if not len(pos):
                    continue
                kr, valid = _rows(k, table, page_size, pos, lengths)
                vr, _ = _rows(v, table, page_size, pos, lengths)
                mask = valid[:, None, None]                       # (B,1,1,n)
                sc = torch.einsum("bgrd,bjgd->bgrj", qf, kr) * scale
                sc = torch.where(mask, sc, torch.tensor(-1e30))
                mn = torch.maximum(m, sc.max(-1).values)
                corr = torch.exp(m - mn)
                p = torch.where(mask, torch.exp(sc - mn[..., None]), 0.0)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + _pv(p, vr, p_terms)
                m = mn
            warps.append((m, l, acc))
        parts.append(_merge(warps))
    nact = torch.clamp(-(-lengths // span), min=1)                # (B,)
    out = torch.empty((B, KV, rep, Dv))
    for b in range(B):
        m, l, acc = _merge([(pm[b], pl[b], pa[b])
                            for pm, pl, pa in parts[:int(nact[b])]])
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, H, Dv)
    return out.to(q.dtype) if rounded else out


def _merge(states):
    """Online-softmax states (m, l, acc) merged in their order."""
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L, A = torch.zeros_like(M), torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = torch.exp(m - M)
        L = L + l * f
        A = A + acc * f[..., None]
    return M, L, A


def _geometry(keys, rep, D, tdt, B, KV, page_size=0):
    return ops._decode_geometry(keys, rep, D, D, tdt, page_size, B, KV, 132)


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


# (B, H, KV, CL, D): GQA, MQA, MHA, rep 5 (hymba-1.5b's 25/5), head dims
# 32, 64, 96 and 128
SHAPES = [(6, 8, 2, 320, 64), (6, 8, 1, 256, 128), (6, 4, 4, 192, 96),
          (6, 10, 2, 256, 32), (6, 5, 1, 320, 64)]


@pytest.mark.parametrize("span_kind", ["geometry", "128"])
@pytest.mark.parametrize("B,H,KV,CL,D", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_emulation_matches_ref_and_pallas(B, H, KV, CL, D, dtype, span_kind):
    """Lengths 0, 1, span - 1, span, span + 1 and CL (a full ring), against
    the plain version and the Pallas kernel."""
    (jq, jk, jv), (q, k, v) = _inputs(
        CL + D + H, [(B, H, D), (B, CL, KV, D), (B, CL, KV, D)], dtype)
    geo = _geometry(CL, H // KV, D, q.dtype, B, KV)
    span = geo.span if span_kind == "geometry" else int(span_kind)
    lengths = np.array([0, 1, span - 1, span, span + 1, CL], np.int32)
    out = split_emulation(q, k, v, torch.from_numpy(lengths), scale=D ** -0.5,
                          span=span, tile=geo.tile)
    assert out.shape == (B, H, D) and out.dtype == q.dtype
    pallas = np.asarray(jops.flash_decode(
        jq, jk, jv, jnp.asarray(lengths), scale=D ** -0.5, block_k=64,
        interpret=True), np.float32)
    plain = ref.flash_decode_ref(q, k, v, torch.from_numpy(lengths),
                                 scale=D ** -0.5).float().numpy()
    got = out.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got[1:], plain[1:], atol=tol, rtol=tol)
    assert not got[0].any()          # the length-0 row: zeros


@pytest.mark.parametrize("B,H,KV,CL,D", [
    (4, 8, 2, 1024, 128),   # the serving head dim and cache, GQA 4:1
    (6, 5, 1, 320, 64),     # rep 5 at d_head 64 (hymba-1.5b)
])
def test_bf16_probabilities_in_two_terms(B, H, KV, CL, D):
    """Why the bfloat16 build feeds P to the mma as bf16(P) + bf16(P -
    bf16(P)): against the float64 product of the same bfloat16 inputs,
    before the output's own rounding, P rounded once errs by 2.6e-4 to
    1.4e-3 here and the two terms by 4e-7 to 2e-6, under the float32
    kernels' 2e-5 (`-s` prints them). Both stay within
    2e-2 once the output is rounded to bfloat16, as the kernel rounds it."""
    _, (q, k, v) = _inputs(CL + D, [(B, H, D), (B, CL, KV, D),
                                    (B, CL, KV, D)], "bfloat16")
    geo = _geometry(CL, H // KV, D, q.dtype, B, KV)
    lens = torch.from_numpy(np.random.default_rng(D).integers(1, CL + 1, B))
    exact = ref.flash_decode_ref(q.double(), k.double(), v.double(), lens,
                                 scale=D ** -0.5)
    err = {}
    for terms in (1, 2):
        kw = dict(scale=D ** -0.5, span=geo.span, tile=geo.tile,
                  p_terms=terms)
        raw = split_emulation(q, k, v, lens, rounded=False, **kw)
        out = split_emulation(q, k, v, lens, **kw)
        err[terms] = float((raw.double() - exact).abs().max())
        assert float((out.double() - exact).abs().max()) <= TOL["bfloat16"]
    print(f"P V before the output's rounding: P once {err[1]:.3g}, "
          f"two terms {err[2]:.3g}")
    assert err[2] <= TOL["float32"] and err[2] * 10 < err[1]


def _paged(rng, B, CL, KV, D, page_size, lengths, tdt):
    """A shuffled block table over a pool larger than the rows need, the
    rows' unallocated blocks on trash page 0 (filled with 100, which no read
    may reach), rows 0 and 1 sharing their first pages; and the same state
    gathered into the slot layout."""
    NB = CL // page_size
    need = [-(-int(n) // page_size) for n in lengths]
    n_pages = 1 + sum(need) + NB
    free = list(rng.permutation(np.arange(1, n_pages)))
    bt = np.zeros((B, NB), np.int32)
    for b in range(B):
        for j in range(need[b]):
            bt[b, j] = free.pop()
    shared = min(need[0], need[1]) // 2
    bt[1, :shared] = bt[0, :shared]
    pools = [torch.from_numpy(rng.standard_normal(
        (n_pages, page_size, KV, D)).astype(np.float32)).to(tdt)
        for _ in range(2)]
    for pool in pools:
        pool[0] = 100.0
    table = torch.from_numpy(bt)
    views = [pool[table.long()].flatten(1, 2) for pool in pools]
    return table, pools, views


@pytest.mark.parametrize("page_size", [8, 16, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_partition_equals_slot_partition_bitwise(page_size, dtype):
    rng = np.random.default_rng(page_size)
    B, H, KV, CL, D = 4, 8, 2, 256, 32
    tdt = DTYPES[dtype][1]
    geo = _geometry(CL, H // KV, D, tdt, B, KV, page_size)
    assert geo.splits == _geometry(CL, H // KV, D, tdt, B, KV).splits
    lengths = np.array([geo.span + 1, geo.span - 1, CL, 37], np.int32)
    table, (kp, vp), (kv, vv) = _paged(rng, B, CL, KV, D, page_size, lengths,
                                       tdt)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(tdt)
    lens = torch.from_numpy(lengths)
    paged = split_emulation(q, kp, vp, lens, scale=0.125, span=geo.span,
                            tile=geo.tile, table=table, page_size=page_size)
    slot = split_emulation(q, kv, vv, lens, scale=0.125, span=geo.span,
                           tile=geo.tile)
    assert torch.equal(paged, slot)
    plain = ref.flash_decode_paged_ref(q, kp, vp, table, lens, scale=0.125)
    np.testing.assert_allclose(paged.float().numpy(), plain.float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,rep,keys", [
    (16, 8, 4, 1024),     # llama3-8b serving
    (16, 8, 4, 512),      # granite-3-2b in the pipeline
    (1, 8, 4, 32768),     # one long row
    (4, 5, 5, 512),       # hymba-1.5b
    (3, 1, 8, 96),        # MQA, a short cache
    (2, 1, 128, 4096),    # 128 query heads on one KV head
])
def test_geometry_is_shape_only_and_splits_slot_and_paged_alike(
        dtype, B, KV, rep, keys):
    geo = _geometry(keys, rep, 128, dtype, B, KV)
    assert geo == _geometry(keys, rep, 128, dtype, B, KV)
    assert geo.span % 64 == 0 and geo.span % geo.tile == 0
    assert geo.splits == -(-keys // geo.span)
    assert geo.splits & (geo.splits - 1) == 0 and geo.splits <= 8
    assert geo.groups * geo.rows >= rep and geo.rows <= 16
    for page_size in (8, 16, 64):
        if keys % page_size == 0:
            paged = _geometry(keys, rep, 128, dtype, B, KV, page_size)
            assert (paged.span, paged.splits, paged.tile) == \
                (geo.span, geo.splits, geo.tile)
            assert paged.table >= geo.span // page_size + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geometry_fits_two_stages_for_every_head_dim(dtype):
    step = 16 if dtype == torch.bfloat16 else 4
    size = 2 if dtype == torch.bfloat16 else 4
    dims = range(step, 257, step)
    for dk in dims:
        for dv in (dk, 64, 256):
            for rep in (1, 4, 5, 8, 16, 128):
                for page_size in (0, 8, 64):
                    geo = _geometry(1024, rep, dk, dtype, 16, 8, page_size) \
                        if dv == dk else ops._decode_geometry(
                            1024, rep, dk, dv, dtype, page_size, 16, 8, 132)
                    # q and the table slice, then two tiles of K and V
                    assert geo.smem >= geo.head_bytes + 2 * geo.tile * (
                        dk + dv) * size
                    assert geo.smem <= SMEM_LIMIT


@pytest.mark.parametrize("dtype,dk,dv", [
    (torch.bfloat16, 8, 8), (torch.bfloat16, 72, 64),
    (torch.bfloat16, 272, 64), (torch.float32, 260, 64),
    (torch.float32, 64, 6), (torch.bfloat16, 0, 64)])
def test_geometry_refuses_head_dims(dtype, dk, dv):
    with pytest.raises(ValueError, match="head dims"):
        ops._decode_geometry(1024, 4, dk, dv, dtype)
