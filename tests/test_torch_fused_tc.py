"""The rounding of the bfloat16 tensor-core fused lm-head loss, emulated on
the CPU, and the wrappers' acceptance rule for it.

`csrc/fused_logprob.cu` runs the bfloat16 forward and backward as wgmma
products on TMA-fed tiles. The forward's products are exact in float32
(bf16 x bf16), so only its summation order changes. The backward writes
each vocab chunk's logits gradient
dl = g_lp 1[v = t] + p (c0 - g_ent l), computed in float32, to bfloat16
scratch, because a bf16 wgmma takes bf16 operands: split in two bf16 terms
bf16(dl) and bf16(dl - bf16(dl)), two wgmmas each in the dh and dW
products (about 16 bits of dl), or rounded once (the alternative that was
weighed). Both products, dh += dl W^T and dW = h^T dl, sum in float32; dh
is rounded to bfloat16 once after the last chunk, dW once per chunk (or
summed as float32 row-range partials first).
`_tc_backward` repeats that arithmetic in plain PyTorch, chunk by chunk as
the kernels walk the vocab, and the tests hold it within the kernels
phase's GRAD_TOL 2e-2 (max abs error over the largest entry) of the port's
plain `ref.blocked_backward` and of the JAX package's gradients (its Pallas
kernel in interpret mode), on bfloat16 inputs made from a numpy seed. The
kernel would round dl once if that stayed under a quarter of GRAD_TOL at
every shape; it does not (4.3e-3 to 5.9e-3 here: the bf16 outputs' own
last bit is 3.9e-3 of the largest entry, and dl's rounding adds about
2e-3 before it), so the kernel splits dl (7e-4 to 2.1e-3).
`test_rounding_decision` prints both and asserts the split's bound.

The wrapper tests need no card: the route by dtype, the chunking, the vocab
splits of the forward, the staging rule for head (and hidden) row strides
that TMA cannot describe, and the refusal of layouts the kernels do not
take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_logprob import fused_logprob as jax_fused
from repro_torch.kernels import ops, ref

GRAD_TOL = 2e-2     # chip_smoke.py GRAD_TOL[bfloat16]: max abs / max entry
DECIDE = GRAD_TOL / 4


def _bf16_round(x):
    return x.to(torch.bfloat16).float()


def _inputs(N, D, V, transpose_head, seed):
    """bf16 hidden (unit normal) and head (std D^-1/2, logits of order 1),
    uniform targets and normal cotangents, as torch tensors and the same
    values as numpy arrays."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((V, D) if transpose_head
                                              else (D, V))
                          * D ** -0.5).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, V, N).astype(np.int64))
    g = torch.from_numpy(rng.standard_normal((3, N)).astype(np.float32))
    return h.to(torch.bfloat16), w.to(torch.bfloat16), t, g


def _tc_backward(h, w, t, lse, ent, g, *, transpose_head, chunk,
                 dw_chunks=1, split=True):
    """(dh, dW) as the tensor-core backward rounds them: per vocab chunk,
    float32 logits and dl, dl rounded to bfloat16 (with `split`, plus
    bf16(dl - bf16(dl))), float32 products; dh rounded once at the end, dW
    per chunk, from float32 partials over 64-aligned row ranges when
    dw_chunks > 1."""
    c0, glp, gent = ref.logits_grad_coef(lse, ent, *g)
    N, D = h.shape
    V = w.shape[0] if transpose_head else w.shape[1]
    hf = h.float()
    wt = (w.T if transpose_head else w).float()            # (D, V)
    rows = ops._tc_part_rows(N, dw_chunks)
    dh = torch.zeros(N, D)
    dw = torch.empty(D, V)
    for v0 in range(0, V, chunk):
        wc = wt[:, v0:v0 + chunk]
        l = hf @ wc
        col = torch.arange(v0, v0 + wc.shape[1])
        p = torch.exp(l - lse[:, None])
        dl = (glp[:, None] * (col[None] == t[:, None]).float()
              + p * (c0[:, None] - gent[:, None] * l))
        terms = [_bf16_round(dl)]
        if split:
            terms.append(_bf16_round(dl - terms[0]))
        for d in terms:
            dh = dh + d @ wc.T
        dw[:, v0:v0 + wc.shape[1]] = sum(
            hf[r:r + rows].T @ d[r:r + rows]
            for r in range(0, N, rows) for d in terms)
        if dw_chunks <= 1:
            dw[:, v0:v0 + wc.shape[1]] = _bf16_round(
                dw[:, v0:v0 + wc.shape[1]])
    dw = (dw.T if transpose_head else dw).to(torch.bfloat16)
    return dh.to(torch.bfloat16), dw


def _rel(out, exp) -> float:
    """Max abs error over the largest entry of `exp`, chip_smoke.py's
    gradient measure."""
    out, exp = np.asarray(out, np.float32), np.asarray(exp, np.float32)
    return float(np.abs(out - exp).max() / max(np.abs(exp).max(), 1e-30))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _errors(N, D, V, transpose_head, dw_chunks, split, seed, jax_too):
    h, w, t, g = _inputs(N, D, V, transpose_head, seed)
    _, lse, ent = ref.fused_logprob_blocked(h, w, t,
                                            transpose_head=transpose_head)
    chunk = ops._vocab_chunk(N, V, torch.bfloat16)
    tc = _tc_backward(h, w, t, lse, ent, g, transpose_head=transpose_head,
                      chunk=chunk, dw_chunks=dw_chunks, split=split)
    plain = ref.blocked_backward(h, w, t, lse, ent, *g,
                                 transpose_head=transpose_head,
                                 dw_chunks=dw_chunks)
    errs = {"plain": max(_rel(_np(a), _np(b)) for a, b in zip(tc, plain))}
    if jax_too:
        jt = jnp.asarray(t.numpy().astype(np.int32))
        cts = g.numpy()

        def scalar(a, b):
            lp, lse_, ent_ = jax_fused(
                a, b, jt, transpose_head=transpose_head, block_n=8,
                block_v=128, dw_chunks=dw_chunks)
            return ((cts[0] * lp).sum() + (cts[1] * lse_).sum()
                    + (cts[2] * ent_).sum())

        jh = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
        jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
        jgrads = jax.grad(scalar, argnums=(0, 1))(jh, jw)
        errs["jax"] = max(_rel(_np(a), _np(b)) for a, b in zip(tc, jgrads))
    return errs


# (N, D, V, transpose_head, dw_chunks): the (D, V) and tied heads, an odd
# V, ragged N, dw_chunks 4, and ~49k vocab with few rows, so that the dh
# sum runs over a real vocabulary (granite's V 49155, one chunk at N 16)
SHAPES = [
    (64, 128, 1000, False, 1),
    (64, 128, 1000, True, 1),
    (40, 64, 777, False, 1),
    (300, 64, 333, True, 1),
    (200, 64, 300, False, 4),
    (16, 256, 49155, False, 1),
]


@pytest.mark.parametrize("split", [False, True], ids=["bf16-dl", "split-dl"])
@pytest.mark.parametrize("N,D,V,transpose_head,dw_chunks", SHAPES)
def test_tc_backward_rounding_within_tolerance(N, D, V, transpose_head,
                                               dw_chunks, split):
    errs = _errors(N, D, V, transpose_head, dw_chunks, split, seed=N + V,
                   jax_too=V < 10000)
    assert all(e <= GRAD_TOL for e in errs.values()), errs


def test_rounding_decision(capsys):
    """The decision: dl split in two bf16 terms stays within a quarter of
    GRAD_TOL of the plain version at every shape. Printed beside it, dl
    rounded once, which does not (so the kernel splits, at the price of a
    second wgmma in each of the dh and dW products)."""
    errs = {split: {(N, D, V, tr, dw): _errors(N, D, V, tr, dw, split,
                                               seed=N + V,
                                               jax_too=False)["plain"]
                    for N, D, V, tr, dw in SHAPES}
            for split in (False, True)}
    with capsys.disabled():
        for split, e in errs.items():
            print(f"\n{'split' if split else 'single'} dl, max abs / max "
                  f"entry against the plain backward:",
                  {str(k): f"{v:.2e}" for k, v in e.items()})
    assert max(errs[True].values()) <= DECIDE, errs[True]


def test_tc_forward_values_are_the_plain_forward():
    """The forward's bf16 products are exact in float32: the emulated
    forward (float32 logits of the bf16 inputs) is the plain version's,
    within float32 summation order, well inside TOL 2e-2."""
    h, w, t, _ = _inputs(48, 128, 777, False, 3)
    out = ref.fused_logprob_blocked(h, w, t)
    oracle = ref.fused_logprob_ref(h.float(), w.float(), t)
    for a, b in zip(out, oracle):
        assert float((a - b).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# the wrappers: route, chunking, splits, staging and refusal
# ---------------------------------------------------------------------------

def test_route_sends_bf16_fused_loss_to_tensor_cores():
    for name in ("fused_logprob_fwd", "fused_logprob_bwd"):
        assert ops.route(name, torch.bfloat16) == "wgmma"
        assert ops.route(name, torch.float32) == "cuda-core"


@pytest.mark.parametrize("N,V,chunks", [
    (4096, 49155, [12416] * 3 + [11907]),   # granite's head (not 3 x 16384
    #                                          and a 3-column chunk)
    (4096, 50280, [12672] * 3 + [12264]),   # mamba2's
    (1024, 128256, [64128, 64128]),         # llama3-8b's
    (16, 50, [50]),
])
def test_bf16_chunks_are_balanced(N, V, chunks):
    chunk = ops._vocab_chunk(N, V, torch.bfloat16)
    got = [min(chunk, V - v0) for v0 in range(0, V, chunk)]
    assert got == chunks
    assert chunk % 128 == 0 or chunk >= V
    assert N * chunk * 4 <= ops._SCRATCH_BYTES


def test_float32_chunks_are_unchanged():
    assert ops._vocab_chunk(4096, 49155, torch.float32) == 16384
    assert ops._vocab_chunk(16, 50, torch.float32) == 128


@pytest.mark.parametrize("row_tiles,v_tiles,sms", [(32, 385, 132),
                                                   (64, 385, 132),
                                                   (8, 1002, 132),
                                                   (1, 1, 132),
                                                   (3, 7, 132)])
def test_forward_splits_fill_the_card(row_tiles, v_tiles, sms):
    n = ops._tc_splits(row_tiles, v_tiles, sms)
    assert 1 <= n <= v_tiles
    per = -(-v_tiles // n)
    waves = -(-row_tiles * n // sms)
    best = min(-(-row_tiles * k // sms) * -(-v_tiles // k)
               for k in range(1, v_tiles + 1))
    assert waves * per == best
    assert (n - 1) * per < v_tiles        # no split without a tile


@pytest.mark.parametrize("N,dw_chunks,rows", [(4096, 1, 4096), (520, 4, 192),
                                              (200, 4, 64), (100, 7, 64)])
def test_dw_part_rows_are_64_aligned(N, dw_chunks, rows):
    assert ops._tc_part_rows(N, dw_chunks) == rows


def test_staging_rule_for_unaligned_rows():
    # granite's untied head: a row stride of 49155 elements (98,310 bytes)
    # is no multiple of 16 bytes, which a TMA map needs: staged
    head = torch.zeros(8, 49155, dtype=torch.bfloat16)
    staged = ops._tc_operand("head", head)
    assert staged.shape == (8, 49160) and staged.stride() == (49160, 1)
    part = ops._tc_operand("head", head[:, :49152])
    assert part.shape == (8, 49152) and part.stride() == (49152, 1)
    # aligned rows are read in place
    tied = torch.zeros(1000, 256, dtype=torch.bfloat16)
    assert ops._tc_operand("head", tied) is tied
    view = torch.zeros(64, 200, dtype=torch.bfloat16)[:, :128]
    assert ops._tc_operand("hidden", view) is view


def test_staged_copy_holds_the_values():
    src = torch.arange(3 * 50, dtype=torch.float32).view(3, 50)
    src = src.to(torch.bfloat16)
    staged = ops._tc_operand("head", src)
    assert staged.shape == (3, 56)
    assert torch.equal(staged[:, :50], src)


def test_refuses_what_the_kernels_do_not_take():
    # a non-unit inner stride: the kernels read rows through TMA
    with pytest.raises(ValueError, match="contiguous"):
        ops._tc_operand("head", torch.zeros(64, 64,
                                            dtype=torch.bfloat16).T)
    with pytest.raises(ValueError, match="2-D"):
        ops._tc_operand("hidden", torch.zeros(4, 4, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        ops._tc_operand("hidden", torch.zeros(4, 8))
