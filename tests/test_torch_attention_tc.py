"""The rounding of the bfloat16 tensor-core attention kernels, emulated on the
CPU, and the wrappers' acceptance rule for them.

`csrc/attention_tc.cuh` computes attention in 64-key tiles with an online
max in base 2, keeps the denominator in float32, feeds the probabilities P
to the PV product in bfloat16 and sums PV in float32 (the Pallas kernels
and the plain versions keep P in float32). The kernel splits P into
bf16(P) and bf16(P - bf16(P)), two PV products; the tests also run P
rounded once to bfloat16, the rounding of a single PV product. `_tc_flash`
and `_tc_prefill` below repeat that arithmetic in plain PyTorch, tile by
tile as the kernels walk the keys, and the tests hold both roundings
within the kernels phase's 2e-2 (max abs, bfloat16) of the port's plain
versions and of the JAX package's oracles on bfloat16 inputs made from a
numpy seed: the new rounding needs no wider tolerance. The shapes are the
serving shape's head dim at S 1024 (a few heads), a sliding window, a ring
cache wrapped twice and Dk 80 / Dv 64; `prefill_attention`'s wide instance
(32-key tiles) at absorbed MLA's Dk 576 / Dv 512. The wrappers' geometry
and acceptance tests need no card: they look at dtypes, head dims, strides
and addresses only.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = 2e-2          # chip_smoke.py TOL[bfloat16]: max abs error
ROWS, KEYS = 128, 64
NEG_INF = -1e30


def _bf16(rng, shape):
    """Unit normals rounded to bfloat16: the torch tensor and the same
    values as a float32 numpy array."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = t.to(torch.bfloat16)
    return t, t.float().numpy()


def _bf16_round(x):
    return x.to(torch.bfloat16).float()


def _online(q, tiles, scale, split):
    """The tensor-core kernels' arithmetic for rows q (R, Dk) in float32
    over key tiles [(k (n, Dk), v (n, Dv), valid (R, n))] in order: scores
    in base 2, masked to -1e30 by selection, the running max and the
    float32 denominator, P rounded to bfloat16 for a float32 PV sum (with
    `split`, plus bf16(P - bf16(P)) for a second); the output
    O / max(l, 1e-30) rounded once to bfloat16."""
    R, Dv = q.shape[0], tiles[0][1].shape[1]
    m = torch.full((R,), NEG_INF)
    l = torch.zeros(R)
    o = torch.zeros(R, Dv)
    for k, v, valid in tiles:
        s = (q @ k.T) * (scale * math.log2(math.e))
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=1).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[:, None])
        l = l * corr + p.sum(dim=1)
        hi = _bf16_round(p)
        o = o * corr[:, None] + hi @ v
        if split:
            o = o + _bf16_round(p - hi) @ v
        m = m_new
    return (o / torch.clamp(l, min=1e-30)[:, None]).to(torch.bfloat16)


def _tc_flash(q, k, v, *, scale, window=0, split=True):
    """flash_attention as the tensor-core kernel rounds it: blocks of 128
    query positions of one head, keys from the block's window start up to
    its last row, in 64-key tiles."""
    B, H, S, _ = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    rep = H // KV
    out = torch.empty(B, H, S, Dv, dtype=torch.bfloat16)
    for b in range(B):
        for h in range(H):
            kf, vf = k[b, h // rep].float(), v[b, h // rep].float()
            for q0 in range(0, S, ROWS):
                rows = torch.arange(q0, min(q0 + ROWS, S))
                hi = int(rows[-1]) + 1
                lo = max(0, q0 - window + 1) if window else 0
                tiles = []
                for k0 in range(lo, hi, KEYS):
                    j = torch.arange(k0, min(k0 + KEYS, hi))
                    valid = j[None] <= rows[:, None]
                    if window:
                        valid &= rows[:, None] - j[None] < window
                    tiles.append((kf[j], vf[j], valid))
                out[b, h, rows] = _online(q[b, h, rows].float(), tiles,
                                          scale, split)
    return out


def _tc_prefill(q, k_chunk, v_chunk, k_cache, v_cache, offset, *, scale,
                split=True, keys=KEYS):
    """prefill_attention as the tensor-core kernel rounds it: the flattened
    (chunk position, rep) rows of one KV head over the cache slots below
    min(offset, CL) with the ring rule, then the chunk's keys causally,
    each pass in tiles of `keys` keys (the wide instance's: 32)."""
    B, C, H, _ = q.shape
    CL, KV = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    rep = H // KV
    pos = torch.arange(C).repeat_interleave(rep)          # flattened rows
    n_cache = min(offset, CL)
    out = torch.empty(B, C, H, Dv, dtype=torch.bfloat16)
    for b in range(B):
        for g in range(KV):
            tiles = []
            for k0 in range(0, n_cache, keys):
                j = torch.arange(k0, min(k0 + keys, n_cache))
                p_j = (offset - 1) - torch.remainder(offset - 1 - j, CL)
                valid = (p_j[None] >= 0) & (offset + pos[:, None] - p_j[None]
                                            < CL)
                tiles.append((k_cache[b, j, g].float(),
                              v_cache[b, j, g].float(), valid))
            for k0 in range(0, C, keys):
                j = torch.arange(k0, min(k0 + keys, C))
                tiles.append((k_chunk[b, j, g].float(),
                              v_chunk[b, j, g].float(),
                              j[None] <= pos[:, None]))
            rows = q[b, :, g * rep:(g + 1) * rep].reshape(C * rep, -1)
            o = _online(rows.float(), tiles, scale, split)
            out[b, :, g * rep:(g + 1) * rep] = o.reshape(C, rep, Dv)
    return out


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


SPLITS = pytest.mark.parametrize("split", [False, True],
                                 ids=["bf16-P", "split-P"])


@SPLITS
@pytest.mark.parametrize("B,H,KV,S,D,window", [
    (1, 4, 2, 1024, 128, 0),   # the serving head dim and length, GQA 2:1
    (1, 4, 2, 300, 64, 64),    # sliding window, S not a multiple of 128
    (2, 4, 4, 77, 32, 0),      # one ragged block, D 32
])
def test_tc_flash_rounding_within_tolerance(B, H, KV, S, D, window, split):
    rng = np.random.default_rng(S + D + window)
    (q, qn), (k, kn), (v, vn) = (_bf16(rng, (B, n, S, D))
                                 for n in (H, KV, KV))
    scale = D ** -0.5
    tc = _tc_flash(q, k, v, scale=scale, window=window, split=split).float()
    plain = ref.flash_attention_ref(q, k, v, scale=scale, window=window)
    assert _max_err(tc, plain.float()) <= TOL
    if not window:    # the JAX oracle has no window
        oracle = jref.flash_attention_ref(jnp.asarray(qn), jnp.asarray(kn),
                                          jnp.asarray(vn), scale=scale)
        assert _max_err(tc, oracle) <= TOL
    if not split:
        # the emulation rounds P: it is not the plain version to the last bit
        assert not torch.equal(tc, plain.float())


@SPLITS
@pytest.mark.parametrize("B,C,H,KV,CL,Dk,Dv,off", [
    (1, 128, 8, 2, 1024, 128, 128, 512),   # the serving chunk, fewer heads
    (1, 8, 4, 4, 32, 32, 32, 72),          # a ring cache wrapped twice
    (2, 4, 8, 2, 32, 64, 64, 36),          # the ring edge inside the chunk
    (2, 12, 6, 1, 48, 80, 64, 40),         # MLA-like Dk 80 / Dv 64, rep 6
    (2, 16, 8, 2, 128, 64, 64, 0),         # offset 0: the chunk pass only
])
def test_tc_prefill_rounding_within_tolerance(B, C, H, KV, CL, Dk, Dv, off,
                                              split):
    rng = np.random.default_rng(C + CL + Dk + off)
    (q, qn), (kh, khn), (vh, vhn), (kc, kcn), (vc, vcn) = (
        _bf16(rng, s) for s in [(B, C, H, Dk), (B, C, KV, Dk), (B, C, KV, Dv),
                                (B, CL, KV, Dk), (B, CL, KV, Dv)])
    scale = Dk ** -0.5
    tc = _tc_prefill(q, kh, vh, kc, vc, off, scale=scale,
                     split=split).float()
    plain = ref.prefill_attention_ref(q, kh, vh, kc, vc, off, scale=scale)
    assert _max_err(tc, plain.float()) <= TOL
    oracle = jref.prefill_attention_ref(
        *(jnp.asarray(a) for a in (qn, khn, vhn, kcn, vcn)), off, scale=scale)
    assert _max_err(tc, oracle) <= TOL


@SPLITS
def test_tc_wide_prefill_rounding_within_tolerance(split):
    """The wide instance's rounding at absorbed MLA's head dims (one KV
    head, Dk 512 + 64, Dv 512, 16 heads here): 32-key tiles over a cache
    of 96 at offset 70 and a chunk of 8."""
    B, C, H, KV, CL, Dk, Dv, off = 1, 8, 16, 1, 96, 576, 512, 70
    rng = np.random.default_rng(576)
    (q, qn), (kh, khn), (vh, vhn), (kc, kcn), (vc, vcn) = (
        _bf16(rng, s) for s in [(B, C, H, Dk), (B, C, KV, Dk), (B, C, KV, Dv),
                                (B, CL, KV, Dk), (B, CL, KV, Dv)])
    scale = (128 + 64) ** -0.5      # the model's: 1 / sqrt(nope + rope)
    tc = _tc_prefill(q, kh, vh, kc, vc, off, scale=scale, split=split,
                     keys=32).float()
    plain = ref.prefill_attention_ref(q, kh, vh, kc, vc, off, scale=scale)
    assert _max_err(tc, plain.float()) <= TOL
    oracle = jref.prefill_attention_ref(
        *(jnp.asarray(a) for a in (qn, khn, vhn, kcn, vcn)), off, scale=scale)
    assert _max_err(tc, oracle) <= TOL


# ---------------------------------------------------------------------------
# the wrappers' acceptance rule for the tensor-core kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dk,dv,stages,smem", [
    (128, 128, 4, 1024 + 2 * 16384 + 64 + 4 * 4 * 8192),
    (64, 64, 4, 1024 + 16384 + 64 + 4 * 2 * 8192),
    (32, 32, 4, 1024 + 16384 + 64 + 4 * 2 * 8192),   # one zero-filled panel
    (80, 64, 4, 1024 + 2 * 16384 + 64 + 4 * 3 * 8192),
    (256, 256, 2, 1024 + 4 * 16384 + 64 + 2 * 8 * 8192),
])
def test_tc_geometry(dk, dv, stages, smem):
    assert ops._tc_geometry(dk, dv) == (stages, smem)
    assert smem <= ops._SMEM_LIMIT


@pytest.mark.parametrize("dk,dv", [(72, 64), (64, 8), (272, 64), (64, 512),
                                   (0, 64)])
def test_tc_geometry_refuses_head_dims(dk, dv):
    with pytest.raises(ValueError, match="multiples of 16"):
        ops._tc_geometry(dk, dv)


def _flash_operands(dtype, D=128, Dv=None):
    """(B, H, S, D) views of (B, S, H, D) projections, as the model passes
    them."""
    def proj(n, d):
        return torch.zeros(2, 96, n, d, dtype=dtype).transpose(1, 2)
    return {"q": proj(8, D), "k": proj(2, D), "v": proj(2, Dv or D)}


def test_route_is_by_dtype():
    for name in ("flash_attention", "prefill_attention", "fused_logprob_fwd",
                 "fused_logprob_bwd"):
        assert ops.route(name, torch.bfloat16) == "wgmma"
        assert ops.route(name, torch.float32) == "cuda-core"
    for name in ("flash_decode", "flash_decode_paged"):
        assert ops.route(name, torch.bfloat16) == "mma"
        assert ops.route(name, torch.float32) == "cuda-core"
    assert ops.route("ssd_scan", torch.bfloat16) == "mma"


@pytest.mark.parametrize("dk,dv", [(128, 128), (64, 64), (32, 32), (80, 64),
                                   (256, 256)])
def test_tc_check_takes_strided_views(dk, dv):
    t = _flash_operands(torch.bfloat16, dk, dv)
    assert ops._check("flash_attention", t, ops._ROWS, dk, dv) == 1


def test_tc_check_refuses_what_the_kernel_does_not_take():
    # a head dim that is a multiple of 16 bytes but not of 16 elements
    t = _flash_operands(torch.bfloat16, 72)
    with pytest.raises(ValueError, match="multiples of 16 up to 256"):
        ops._check("flash_attention", t, ops._ROWS, 72, 72)
    # float32 takes it: the CUDA-core kernel's rule
    t32 = _flash_operands(torch.float32, 72)
    assert ops._check("flash_attention", t32, ops._ROWS, 72, 72) == 0
    # wider than 256: the 128-row tensor-core kernel refuses, whatever
    # would fit (prefill_attention's wide instance takes such head dims,
    # `ops._prefill_geometry`; flash_attention has none)
    t = _flash_operands(torch.bfloat16, 512)
    with pytest.raises(ValueError, match="up to 256"):
        ops._check("flash_attention", t, ops._ROWS, 512, 512)
    assert ops._prefill_geometry(512, 512, torch.bfloat16).kernel == "tc-wide"
    # the CUDA-core kernel refuses it for its shared memory
    t32 = _flash_operands(torch.float32, 512)
    with pytest.raises(ValueError, match="shared memory"):
        ops._check("flash_attention", t32, ops._ROWS, 512, 512)
    # a row stride that is not a multiple of 16 bytes (TMA's rule)
    base = torch.zeros(1, 4, 64, 132, dtype=torch.bfloat16)
    t = {"q": base[..., :128], "k": base[:, :2, :, :128],
         "v": base[:, :2, :, :128]}
    with pytest.raises(ValueError, match="16-byte row strides"):
        ops._check("flash_attention", t, ops._ROWS, 128, 128)
    # a start that is not 16-byte aligned
    flat = torch.zeros(4 * 64 * 128 + 4, dtype=torch.bfloat16)
    q = flat[4:].view(1, 4, 64, 128)
    t = {"q": q, "k": q[:, :2], "v": q[:, :2]}
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._check("flash_attention", t, ops._ROWS, 128, 128)
    # a last dim that is not contiguous
    t = _flash_operands(torch.bfloat16)
    t["k"] = torch.zeros(2, 2, 128, 96, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous last dim"):
        ops._check("flash_attention", t, ops._ROWS, 128, 128)
