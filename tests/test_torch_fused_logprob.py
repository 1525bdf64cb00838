"""The port's fused lm-head loss (`repro_torch.kernels.ops.fused_logprob`)
on the CPU, where the wrapper runs its vocab-blocked plain version, against
the JAX package's Pallas kernel in interpret mode (`repro.kernels.ops`) and
its full-logits oracle (`repro.kernels.ref.fused_logprob_ref`).

Inputs are made with numpy from a seed and handed to both packages. The
shapes are those of `tests/test_fused_logprob.py`. Tolerances: values 2e-5
in float32 (both sides sum the logits in float32, in another order) and
2e-2 in bfloat16 (the inputs are the same bf16 values; only the summation
order differs, but bf16 logits reach 10); gradients 2e-4, as the JAX
package's own test of its kernel against the oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_logprob import fused_logprob as jax_fused
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [
    (32, 64, 128, 8, 64),     # vocab tiled in two blocks
    (64, 32, 96, 128, 512),   # blocks larger than the problem
    (16, 64, 50, 8, 16),      # odd V % block remainder (50 = 3*16 + 2)
    (24, 32, 33, 4, 7),       # pathological blocks, V % block != 0
]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _inputs(N, D, V, transpose_head, dtype="float32", seed=0):
    """(jax arrays, torch tensors) of the same hidden, head and targets."""
    rng = np.random.default_rng(seed + N + V)
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((V, D) if transpose_head else (D, V))
         * 0.3).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(h).astype(jdt), jnp.asarray(w).astype(jdt),
             jnp.asarray(t)),
            (torch.from_numpy(h).to(tdt), torch.from_numpy(w).to(tdt),
             torch.from_numpy(t).long()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("N,D,V,bn,bv", SHAPES)
@pytest.mark.parametrize("transpose_head", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_values_match_pallas_and_oracle(N, D, V, bn, bv, transpose_head,
                                        dtype):
    (jh, jw, jt), (h, w, t) = _inputs(N, D, V, transpose_head, dtype)
    out = ops.fused_logprob(h, w, t, transpose_head=transpose_head)
    pallas = jops.fused_logprob(jh, jw, jt, transpose_head=transpose_head,
                                block_n=bn, block_v=bv)
    oracle = jref.fused_logprob_ref(jh, jw, jt, transpose_head=transpose_head)
    for o, p, r, name in zip(out, pallas, oracle, ("logprob", "lse",
                                                   "entropy")):
        assert o.dtype == torch.float32 and o.shape == (N,)
        np.testing.assert_allclose(_np(o), _np(p), **_tol(dtype),
                                   err_msg=f"{name} vs pallas")
        np.testing.assert_allclose(_np(o), _np(r), **_tol(dtype),
                                   err_msg=f"{name} vs oracle")


def _cotangents(N, seed=1):
    return np.random.default_rng(seed).standard_normal((3, N)).astype(
        np.float32)


def _port_grads(h, w, t, cts, transpose_head, dw_chunks=1):
    h, w = h.clone().requires_grad_(), w.clone().requires_grad_()
    out = ops.fused_logprob(h, w, t, transpose_head=transpose_head,
                            dw_chunks=dw_chunks)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cts])
    return h.grad, w.grad


def _jax_grads(fn, jh, jw, cts):
    def scalar(h, w):
        lp, lse, ent = fn(h, w)
        return (cts[0] * lp).sum() + (cts[1] * lse).sum() \
            + (cts[2] * ent).sum()
    return jax.grad(scalar, argnums=(0, 1))(jh, jw)


@pytest.mark.parametrize("N,D,V,bn,bv", [SHAPES[0], SHAPES[2]])
@pytest.mark.parametrize("transpose_head", [False, True])
def test_grads_match_jax_grad(N, D, V, bn, bv, transpose_head):
    """dh and dW (through all three outputs) against jax.grad of the
    Pallas kernel's custom VJP and of the full-logits oracle."""
    (jh, jw, jt), (h, w, t) = _inputs(N, D, V, transpose_head)
    cts = _cotangents(N)
    dh, dw = _port_grads(h, w, t, cts, transpose_head)
    assert dh.shape == h.shape and dw.shape == w.shape
    for fn in (lambda a, b: jops.fused_logprob(
                   a, b, jt, transpose_head=transpose_head, block_n=bn,
                   block_v=bv),
               lambda a, b: jref.fused_logprob_ref(
                   a, b, jt, transpose_head=transpose_head)):
        jdh, jdw = _jax_grads(fn, jh, jw, cts)
        np.testing.assert_allclose(_np(dh), _np(jdh), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(_np(dw), _np(jdw), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dw_chunks", [2, 3])
@pytest.mark.parametrize("transpose_head", [False, True])
def test_dw_chunks_parity(dw_chunks, transpose_head):
    """The row-chunked head gradient equals the single pass (1e-5, a
    reassociated float32 sum) and the JAX kernel with the same dw_chunks."""
    (jh, jw, jt), (h, w, t) = _inputs(48, 32, 64, transpose_head)
    cts = _cotangents(48, seed=2)
    base = _port_grads(h, w, t, cts, transpose_head)
    got = _port_grads(h, w, t, cts, transpose_head, dw_chunks=dw_chunks)
    jgot = _jax_grads(lambda a, b: jax_fused(
        a, b, jt, block_n=8, transpose_head=transpose_head,
        dw_chunks=dw_chunks), jh, jw, cts)
    for a, b, c in zip(got, base, jgot):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(a), _np(c), atol=2e-4, rtol=2e-4)


def test_bf16_grads_in_input_dtypes():
    """bf16 hidden and head: dh comes back in the hidden dtype and dW in
    the head's, within 5e-2 of the float32-accumulated JAX kernel (the
    same bound as the JAX package's bf16 gradient test)."""
    (jh, jw, jt), (h, w, t) = _inputs(32, 64, 96, False, "bfloat16")
    cts = np.ones((3, 32), np.float32)
    dh, dw = _port_grads(h, w, t, cts, False)
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    jdh, jdw = _jax_grads(lambda a, b: jops.fused_logprob(
        a, b, jt, block_n=8, block_v=32), jh, jw, cts)
    np.testing.assert_allclose(_np(dh), _np(jdh), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(_np(dw), _np(jdw), atol=5e-2, rtol=5e-2)


def test_blocked_twin_matches_port_oracle():
    """Within the port: the blocked twin against the full-logits oracle,
    values and gradients (the oracle differentiated by autograd)."""
    _, (h, w, t) = _inputs(40, 32, 77, True)
    cts = [torch.from_numpy(c) for c in _cotangents(40, seed=3)]
    grads = []
    for fn in (ref.fused_logprob_blocked, ref.fused_logprob_ref):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(hh, ww, t, transpose_head=True)
        torch.autograd.backward(out, cts)
        grads.append((out, hh.grad, ww.grad))
    (o1, dh1, dw1), (o2, dh2, dw2) = grads
    for a, b in zip(o1, o2):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(dh1, dh2, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(dw1, dw2, atol=2e-4, rtol=2e-4)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the blocked twin (bit for bit) and
    launches nothing."""
    _, (h, w, t) = _inputs(16, 64, 50, False)
    before = dict(ops.launches)
    out = ops.fused_logprob(h, w, t)
    plain = ref.fused_logprob_blocked(h, w, t)
    for a, b in zip(out, plain):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    hh = h.clone().requires_grad_()
    sum(x.sum() for x in ops.fused_logprob(hh, w, t)).backward()
    assert ops.launches == before


def test_forward_only_attention_refuses_grad():
    """The check each CUDA attention wrapper runs before its launch: a
    differentiated call raises instead of returning an output with no
    autograd history; under no_grad, or on detached inputs, it passes."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops._forward_only("flash_attention", q, k)
    with torch.no_grad():
        ops._forward_only("flash_attention", q, k)
    ops._forward_only("flash_attention", q.detach(), k)
