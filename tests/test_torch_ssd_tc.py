"""The rounding of the bfloat16 tensor-core SSD scan, emulated on the CPU,
and the wrapper's geometry for it.

`csrc/ssd_scan.cu` runs the bfloat16 scan on mma.sync m16n8k16 (bf16
operands, float32 sums). Per chunk of Q tokens and head, with A_cum the
prefix sum of dt * A (in float64) and w = exp(A_cum[Q-1] - A_cum) dt:

- S = C B^T, both operands exact bf16 inputs: exact products, float32 sums;
- S' = S exp(A_cum[i] - A_cum[j]) dt[j] in float32 (0 above the diagonal),
  rounded to bf16 as hi = bf16(S') and lo = bf16(S' - hi);
- y = exp(A_cum) (C state) + S' x, the float32 state entering as hi and lo
  terms, C and x exact; y rounded to bf16 once;
- state = exp(A_cum[Q-1]) state + (w x)^T B, w x formed in float32 and
  split in hi and lo, B exact.

`_tc_scan` repeats that arithmetic in plain PyTorch, chunk by chunk as the
kernel walks the row, and the tests hold it to a quarter of chip_smoke.py's
SSD_TOL[bfloat16] (|d| <= atol + rtol |exact| with (5e-2, 5e-2)) against
the plain `ref.ssd_scan_ref` in float64 and against the JAX package's
Pallas `ssd_scan` in interpret mode, on bf16 inputs made from a numpy seed.
Rounding every float32 operand once (`split=False`) instead would cost one
mma per product where the split costs two; it leaves 0.33-0.57 of the
tolerance at 128 tokens and exceeds it (1.6x) over a 512-token row, while
the split stays at the bf16 output's own rounding (0.065-0.076), so every
product splits. `test_rounding_decision` prints both and asserts the
split's bound.

The kernel walks a divisor of the caller's chunk up to 64 tokens long
where the chunk is longer or its tiles do not fit; the scan does not
depend on its chunking but for rounding, and `_tc_scan` at the kernel's
chunk is held to the float64 plain scan at the caller's.

The geometry tests need no card: `ops._ssd_geometry` from the shapes alone
(the chunk walked, heads per block, threads, shared memory, resident warps)
at mamba2-2.7b's and hymba-1.5b's widths, for every shape of
chip_smoke.py's ssd_scan cases, at the widths the layout reaches, and its
refusals; `ops._aligned16`, which sends unaligned views to the kernel's
element-wise staging.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ATOL, RTOL = chip_smoke.SSD_TOL[torch.bfloat16]
DECIDE = 0.25      # of the tolerance


def _bf16_round(x):
    return x.to(torch.bfloat16).float()


def _terms(v, split):
    """v as the bf16 terms the kernel feeds an mma: hi, and with `split`
    lo = bf16(v - hi)."""
    hi = _bf16_round(v)
    return [hi, _bf16_round(v - hi)] if split else [hi]


def _tc_scan(x, dt, A, B, C, chunk, split=True):
    """(y, state) as the bf16 kernel rounds them: x, B, C (b,l,h,p) /
    (b,l,g,n) bf16 values, dt (b,l,h) and A (h,) float32; y (b,l,h,p) in
    bf16, the final state (b,h,n,p) float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    x, B, C = x.float(), B.float(), C.float()
    y = torch.empty(b, l, h, p)
    st = torch.zeros(b, h, p, n)                       # state^T, float32
    i = torch.arange(chunk)
    low = i[:, None] >= i[None, :]
    for c0 in range(0, l, chunk):
        xs = x[:, c0:c0 + chunk].permute(0, 2, 1, 3)    # (b,h,Q,p)
        d = dt[:, c0:c0 + chunk].permute(0, 2, 1)        # (b,h,Q)
        Bs = B[:, c0:c0 + chunk].permute(0, 2, 1, 3).repeat_interleave(rep, 1)
        Cs = C[:, c0:c0 + chunk].permute(0, 2, 1, 3).repeat_interleave(rep, 1)
        acum = torch.cumsum(d.double() * A.double()[None, :, None], -1)
        seg = (acum[..., :, None] - acum[..., None, :]).float()
        S = Cs @ Bs.transpose(-1, -2)
        Sp = torch.where(low, S * torch.exp(torch.where(low, seg, 0.0))
                         * d[..., None, :], 0.0)
        off = sum(Cs @ t.transpose(-1, -2) for t in _terms(st, split))
        yc = off * torch.exp(acum.float())[..., None] \
            + sum(t @ xs for t in _terms(Sp, split))
        y[:, c0:c0 + chunk] = yc.permute(0, 2, 1, 3)
        last = acum[..., -1:]
        w = torch.exp((last - acum).float()) * d
        xw = xs * w[..., None]
        st = st * torch.exp(last.float())[..., None] + sum(
            t.transpose(-1, -2) @ Bs for t in _terms(xw, split))
    return _bf16_round(y), st.transpose(-1, -2)


def _inputs(b, l, h, p, g, n, seed):
    """bf16 x, B, C (unit normal) and float32 dt = softplus(normal), A =
    -exp(normal), in the JAX tests' law, as torch tensors."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    x = t(rng.standard_normal((b, l, h, p)).astype(np.float32))
    dt = t(np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32))
    A = t((-np.exp(rng.standard_normal(h))).astype(np.float32))
    B = t(rng.standard_normal((b, l, g, n)).astype(np.float32))
    C = t(rng.standard_normal((b, l, g, n)).astype(np.float32))
    return (x.to(torch.bfloat16), dt, A, B.to(torch.bfloat16),
            C.to(torch.bfloat16))


def _ratio(out, exp) -> float:
    """The largest |out - exp| / (atol + rtol |exp|) over y and the state,
    chip_smoke.py's ssd_scan measure."""
    return max(float(((o.double() - e.double()).abs()
                      / (ATOL + RTOL * e.double().abs())).max())
               for o, e in zip(out, exp))


def _exact(ins, chunk):
    return ref.ssd_scan_ref(*(t.double() for t in ins), chunk=chunk)


# (b, l, h, p, g, n, chunk): mamba2-2.7b's widths at a short length,
# hymba-1.5b's state 16, and an awkward case (N 8, P 16, chunk 16, heads
# repeating over 3 groups)
SHAPES = [
    (1, 128, 2, 64, 1, 128, 64),
    (1, 128, 2, 64, 1, 16, 64),
    (1, 48, 6, 16, 3, 8, 16),
]


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", SHAPES)
def test_tc_scan_within_a_quarter_of_the_tolerance(b, l, h, p, g, n, chunk):
    """Against the float64 plain scan and the Pallas kernel in interpret
    mode on the same bf16 values."""
    ins = _inputs(b, l, h, p, g, n, seed=l + n)
    tc = _tc_scan(*ins, chunk)
    assert tc[0].shape == (b, l, h, p) and tc[1].shape == (b, h, n, p)
    x, dt, A, B, C = (jnp.asarray(t.float().numpy()) for t in ins)
    jy, jst = jax_ssd_scan(x.astype(jnp.bfloat16), dt, A,
                           B.astype(jnp.bfloat16), C.astype(jnp.bfloat16),
                           chunk=chunk, interpret=True)
    pallas = (torch.from_numpy(np.array(jy.astype(jnp.float32))),
              torch.from_numpy(np.array(jst)))
    errs = {"float64": _ratio(tc, _exact(ins, chunk)),
            "pallas": _ratio(tc, pallas)}
    assert all(e <= DECIDE for e in errs.values()), errs


@pytest.mark.parametrize("chunk,q", [(128, 64), (96, 48)])
def test_kernel_chunk_divides_the_callers(chunk, q):
    """A chunk over 64 is walked in the geometry's divisor of it: the
    float64 scan is the same at both chunkings, and the bf16 route's
    emulation at the kernel's chunk stays within a quarter of the
    tolerance of the float64 scan at the caller's."""
    assert ops._ssd_geometry(4, 64, 1, 64, chunk, torch.bfloat16).q == q
    ins = _inputs(1, 2 * chunk, 2, 64, 1, 64, seed=chunk)
    exact = _exact(ins, chunk)
    for a, e in zip(_exact(ins, q), exact):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-10)
    assert _ratio(_tc_scan(*ins, q), exact) <= DECIDE


def test_rounding_decision(capsys):
    """The decision: every float32 operand split in two bf16 terms stays
    within a quarter of the tolerance of the float64 plain scan, here and
    over a 512-token row. Printed beside it, each rounded once, which does
    not (1.6x the tolerance over 512 tokens)."""
    shapes = SHAPES + [(1, 512, 4, 64, 1, 128, 64)]
    errs = {}
    for split in (False, True):
        errs[split] = {}
        for b, l, h, p, g, n, chunk in shapes:
            ins = _inputs(b, l, h, p, g, n, seed=l + n)
            errs[split][(l, h, p, g, n, chunk)] = _ratio(
                _tc_scan(*ins, chunk, split=split), _exact(ins, chunk))
    with capsys.disabled():
        for split, e in errs.items():
            print(f"\n{'split' if split else 'single'} rounding, share of "
                  f"SSD_TOL[bfloat16] against float64:",
                  {str(k): f"{v:.3f}" for k, v in e.items()})
    assert max(errs[True].values()) <= DECIDE, errs[True]
    assert max(errs[False].values()) > 1.0, errs[False]


# ---------------------------------------------------------------------------
# the wrapper: route and geometry
# ---------------------------------------------------------------------------

def test_route_sends_bf16_scan_to_tensor_cores():
    assert ops.route("ssd_scan", torch.bfloat16) == "mma"
    assert ops.route("ssd_scan", torch.float32) == "cuda-core"


def test_mamba2_geometry_fits_and_states_its_warps():
    """mamba2-2.7b (80 heads of 64 over one group, state 128, chunk 64):
    bfloat16 takes 4 heads per 512-thread block, its ring and per-head
    scratch within the block's shared memory, one block and 16 warps
    resident per SM (the CUDA-core kernel of before: one 8-warp block);
    float32 one head per 256-thread block, one block per SM."""
    geo = ops._ssd_geometry(80, 64, 1, 128, 64, torch.bfloat16)
    assert (geo.q, geo.heads, geo.threads, geo.qp, geo.np, geo.pp) == \
        (64, 4, 512, 64, 128, 64)
    assert geo.smem <= ops._SMEM_LIMIT
    assert (geo.blocks_per_sm, geo.warps_per_sm) == (1, 16)
    f32 = ops._ssd_geometry(80, 64, 1, 128, 64, torch.float32)
    assert (f32.q, f32.heads, f32.threads) == (64, 1, 256)
    assert f32.smem <= ops._SMEM_LIMIT
    assert (f32.blocks_per_sm, f32.warps_per_sm) == (1, 8)


def test_hymba_geometry():
    """hymba-1.5b: 50 heads (4 do not divide them), state 16."""
    geo = ops._ssd_geometry(50, 64, 1, 16, 64, torch.bfloat16)
    assert (geo.heads, geo.threads, geo.np) == (2, 256, 16)
    assert geo.warps_per_sm >= 16


@pytest.mark.parametrize("h,g,n,heads", [(80, 1, 128, 4), (50, 1, 16, 2),
                                         (6, 2, 128, 1)])
def test_heads_per_block_lay_out_shared_memory(h, g, n, heads):
    """Each heads-per-block layout, from the shapes that select it
    (mamba2: 80 heads a group, hymba: 50, and 3): the ring's two stages
    (B and C once, x and dt per head) and the per-head scratch, as
    csrc/ssd_scan.cu `Layout` carves them."""
    geo = ops._ssd_geometry(h, 64, g, n, 64, torch.bfloat16)
    assert geo.heads == heads
    stage = 2 * 64 * (n * 2 + 16) + heads * (64 * (64 * 2 + 16) + 4 * 64)
    head = 2 * 64 * (64 * 2 + 16) + 16 * 64 + 16
    assert geo.smem == 2 * stage + heads * head
    assert geo.threads == 128 * heads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_chip_case_is_accepted(dtype):
    for label, a in chip_smoke.ssd_cases():
        geo = ops._ssd_geometry(a["h"], a["p"], a["g"], a["n"], a["chunk"],
                                dtype)
        assert (a["h"] // a["g"]) % geo.heads == 0, label
        assert geo.smem <= ops._SMEM_LIMIT and geo.blocks_per_sm >= 1, label
        assert a["chunk"] % geo.q == 0 and geo.q <= geo.qp <= 64, label
        assert geo.qp % 16 == 0, label


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk,n,p,q", [(64, 256, 64, (32, 64)),
                                         (64, 128, 128, (32, 64)),
                                         (64, 64, 256, (32, 64)),
                                         (128, 16, 64, (64, 64)),
                                         (67, 16, 64, (1, 1))])
def test_geometry_reaches_past_one_tile(dtype, chunk, n, p, q):
    """Widths the kernel of before took (any its float32 shared memory
    held): N 256, P 128 and 256, chunks over 64, each walked in a divisor
    of the chunk whose tiles fit (float32, bfloat16)."""
    geo = ops._ssd_geometry(4, p, 1, n, chunk, dtype)
    assert geo.q == q[dtype == torch.bfloat16]
    assert geo.smem <= ops._SMEM_LIMIT and geo.threads <= 512
    if dtype == torch.bfloat16 and geo.np > 128:
        assert geo.threads <= 256       # the state's 128 registers a thread


@pytest.mark.parametrize("dtype,chunk,n,p,why", [
    (torch.bfloat16, 64, 512, 64, "holds the state in registers"),
    (torch.bfloat16, 64, 256, 256, "256 threads"),
    (torch.bfloat16, 16, 16, 512, "512 threads"),
    (torch.float32, 16, 512, 64, "shared memory"),
    (torch.float32, 64, 256, 256, "shared memory"),
])
def test_geometry_refuses_what_the_kernel_does_not_take(dtype, chunk, n, p,
                                                         why):
    with pytest.raises(ValueError, match=why):
        ops._ssd_geometry(4, p, 1, n, chunk, dtype)


def test_aligned16_sends_skewed_views_to_staging():
    """The model's views of one conv output (mamba2's widths) copy by
    cp.async; views of rows one element wider (chip_smoke.py's `skew`),
    starting on the row or one element into it, do not, nor does a
    contiguous tensor whose data starts one element off."""
    h, p, n = 8, 64, 128
    for dtype in (torch.float32, torch.bfloat16):
        xbc = torch.zeros(2, 16, h * p + 2 * n, dtype=dtype)
        x = xbc[..., :h * p].view(2, 16, h, p)
        B = xbc[..., h * p:h * p + n].view(2, 16, 1, n)
        C = xbc[..., h * p + n:].view(2, 16, 1, n)
        assert ops._aligned16(x, B, C)
        wide = torch.zeros(2, 16, 1 + h * p + 2 * n, dtype=dtype)
        for skew in (0, 1):
            x = wide[..., skew:skew + h * p].view(2, 16, h, p)
            assert not ops._aligned16(x)
        flat = torch.zeros(1 + 2 * 16 * h * p, dtype=dtype)
        assert not ops._aligned16(flat[1:].view(2, 16, h, p))
