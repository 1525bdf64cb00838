"""The port's attention kernels (`repro_torch.kernels.ops`) on the CPU, where
each wrapper runs its plain PyTorch version, against the JAX package's Pallas
kernels in interpret mode and against its `repro.kernels.ref` oracles.

Inputs are made with numpy from a seed and handed to both packages. The
sweeps are those of `tests/test_kernels.py`: MHA, GQA, MQA, S not a
multiple of 128, a full ring, a ring wrapped twice, offset 0. Tolerance:
2e-5 in float32 (both sides compute in float32 and sum in another order),
2e-2 in bfloat16 (the JAX oracles round the softmax weights to bfloat16
before the PV product; the kernels keep them in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

# the oracles, jitted: eager jnp dispatches (and compiles) op by op. The
# full-sequence oracle stays eager: jitted, XLA's CPU backend has no batched
# bfloat16 x bfloat16 -> float32 dot
DECODE_REF = jax.jit(jref.flash_decode_ref, static_argnames=("scale",))
PREFILL_REF = jax.jit(jref.prefill_attention_ref, static_argnames=("scale",))

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, shapes, dtype):
    """The same unit-normal arrays for both packages."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(port, *refs, dtype):
    for r in refs:
        np.testing.assert_allclose(_np(port), _np(r), **_tol(dtype))


@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 4, 4, 128, 64),    # MHA
    (2, 8, 2, 256, 64),    # GQA 4:1
    (1, 8, 1, 128, 128),   # MQA
    (2, 4, 4, 192, 32),    # S not a multiple of 128
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_pallas_and_ref(B, H, KV, S, D, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(
        S + D, [(B, H, S, D), (B, KV, S, D), (B, KV, S, D)], dtype)
    out = ops.flash_attention(q, k, v, scale=D ** -0.5)
    assert out.shape == (B, H, S, D) and out.dtype == q.dtype
    bq = 64 if S % 64 == 0 else S
    pallas = jops.flash_attention(jq, jk, jv, scale=D ** -0.5, block_q=bq,
                                  block_k=bq)
    oracle = jref.flash_attention_ref(jq, jk, jv, scale=D ** -0.5)
    _assert_close(out, pallas, oracle, dtype=dtype)


def test_flash_attention_window_matches_blocked_twin():
    """The sliding-window mask (the JAX package computes it with its jnp
    twin, which the Pallas kernel does not cover)."""
    from repro.models.attention import _naive_causal_attention
    B, H, KV, S, D, W = 1, 4, 2, 96, 32, 24
    (jq, jk, jv), (q, k, v) = _inputs(3, [(B, H, S, D), (B, KV, S, D),
                                          (B, KV, S, D)], "float32")
    out = ops.flash_attention(q, k, v, scale=D ** -0.5, window=W)
    exp = _naive_causal_attention(jnp.swapaxes(jq, 1, 2),
                                  jnp.swapaxes(jk, 1, 2),
                                  jnp.swapaxes(jv, 1, 2), scale=D ** -0.5,
                                  window=W)
    _assert_close(out, jnp.swapaxes(exp, 1, 2), dtype="float32")


@pytest.mark.parametrize("B,H,KV,CL,D,block", [
    (2, 8, 2, 128, 64, 32),
    (1, 4, 4, 256, 64, 64),
    (3, 8, 1, 64, 128, 64),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_matches_pallas_and_ref(B, H, KV, CL, D, block, dtype):
    (jq, jkc, jvc), (q, kc, vc) = _inputs(
        CL + D, [(B, H, D), (B, CL, KV, D), (B, CL, KV, D)], dtype)
    lengths = np.arange(1, B + 1) * (CL // (B + 1)) + 1
    out = ops.flash_decode(q, kc, vc, torch.from_numpy(lengths),
                           scale=D ** -0.5)
    assert out.shape == (B, H, D) and out.dtype == q.dtype
    pallas = jops.flash_decode(jq, jkc, jvc, jnp.asarray(lengths),
                               scale=D ** -0.5, block_k=block)
    oracle = DECODE_REF(jq, jkc, jvc, jnp.asarray(lengths), scale=D ** -0.5)
    _assert_close(out, pallas, oracle, dtype=dtype)


def test_flash_decode_full_ring():
    """lengths == CL attends to every slot (ring-buffer mode)."""
    B, H, KV, CL, D = 1, 4, 2, 64, 32
    (jq, jkc, jvc), (q, kc, vc) = _inputs(
        1, [(B, H, D), (B, CL, KV, D), (B, CL, KV, D)], "float32")
    lengths = np.full((B,), CL)
    out = ops.flash_decode(q, kc, vc, torch.from_numpy(lengths),
                           scale=D ** -0.5)
    pallas = jops.flash_decode(jq, jkc, jvc, jnp.asarray(lengths),
                               scale=D ** -0.5, block_k=32)
    oracle = DECODE_REF(jq, jkc, jvc, jnp.asarray(lengths), scale=D ** -0.5)
    _assert_close(out, pallas, oracle, dtype="float32")


@pytest.mark.parametrize("B,H,KV,C,CL,D,off,block", [
    (2, 4, 2, 16, 128, 32, 0, 64),     # first chunk: empty cache
    (2, 4, 2, 16, 128, 32, 48, 64),    # mid-prompt, full-length cache
    (1, 8, 1, 8, 64, 64, 64, 32),      # MQA, ring exactly full
    (1, 4, 4, 8, 32, 16, 72, 16),      # MHA, ring wrapped twice
    (2, 8, 2, 4, 32, 64, 36, 32),      # chunk straddling the ring window
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_attention_matches_pallas_and_ref(B, H, KV, C, CL, D, off,
                                                  block, dtype):
    shapes = [(B, C, H, D), (B, C, KV, D), (B, C, KV, D), (B, CL, KV, D),
              (B, CL, KV, D)]
    (jq, jkh, jvh, jkc, jvc), (q, kh, vh, kc, vc) = _inputs(
        off + CL, shapes, dtype)
    out = ops.prefill_attention(q, kh, vh, kc, vc, off, scale=D ** -0.5)
    assert out.shape == (B, C, H, D) and out.dtype == q.dtype
    pallas = jops.prefill_attention(jq, jkh, jvh, jkc, jvc, jnp.int32(off),
                                    scale=D ** -0.5, block_k=block)
    oracle = PREFILL_REF(jq, jkh, jvh, jkc, jvc, off, scale=D ** -0.5)
    _assert_close(out, pallas, oracle, dtype=dtype)


def test_prefill_attention_dk_differs_from_dv():
    """Separate key and value widths (MLA's absorbed prefill: KV=1,
    Dk = latent + rope, Dv = latent)."""
    B, C, H, CL, Dk, Dv, off = 2, 4, 4, 32, 48, 32, 20
    shapes = [(B, C, H, Dk), (B, C, 1, Dk), (B, C, 1, Dv), (B, CL, 1, Dk),
              (B, CL, 1, Dv)]
    (jq, jkh, jvh, jkc, jvc), (q, kh, vh, kc, vc) = _inputs(5, shapes,
                                                             "float32")
    out = ops.prefill_attention(q, kh, vh, kc, vc, off, scale=Dk ** -0.5)
    assert out.shape == (B, C, H, Dv)
    oracle = PREFILL_REF(jq, jkh, jvh, jkc, jvc, off, scale=Dk ** -0.5)
    _assert_close(out, oracle, dtype="float32")


def test_prefill_ring_rule_matches_sequential_window():
    """Independent oracle: build the ring cache by sequential writes of an
    absolute K/V history; every chunk query must attend exactly the window
    [qp-CL+1, qp] of that history. Exercises the floor-mod ring rule."""
    B, H, KV, D, CL, C = 1, 4, 2, 16, 8, 4
    rep = H // KV
    for off in (0, 4, 8, 12, 20):
        rng = np.random.default_rng(off)
        S = off + C
        kfull = rng.standard_normal((B, S, KV, D)).astype(np.float32)
        vfull = rng.standard_normal((B, S, KV, D)).astype(np.float32)
        q = rng.standard_normal((B, C, H, D)).astype(np.float32)
        kc = np.zeros((B, CL, KV, D), np.float32)
        vc = np.zeros((B, CL, KV, D), np.float32)
        for p in range(off):
            kc[:, p % CL] = kfull[:, p]
            vc[:, p % CL] = vfull[:, p]
        t = torch.from_numpy
        out = ops.prefill_attention(t(q), t(kfull[:, off:]),
                                    t(vfull[:, off:]), t(kc), t(vc), off,
                                    scale=D ** -0.5).numpy()
        exp = np.zeros_like(out)
        for i in range(C):
            qp = off + i
            lo = max(0, qp - CL + 1)
            for h in range(H):
                g = h // rep
                s = kfull[0, lo:qp + 1, g] @ q[0, i, h] * D ** -0.5
                w = np.exp(s - s.max())
                exp[0, i, h] = (w / w.sum()) @ vfull[0, lo:qp + 1, g]
        np.testing.assert_allclose(out, exp, atol=2e-5, rtol=2e-5,
                                   err_msg=f"offset {off}")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    B, H, KV, CL, D = 2, 4, 2, 32, 16
    _, (q, kc, vc) = _inputs(9, [(B, H, D), (B, CL, KV, D), (B, CL, KV, D)],
                             "float32")
    lengths = torch.tensor([5, 32])
    before = dict(ops.launches)
    out = ops.flash_decode(q, kc, vc, lengths, scale=0.25)
    torch.testing.assert_close(
        out, ref.flash_decode_ref(q, kc, vc, lengths, scale=0.25),
        rtol=0, atol=0)
    pool_k, pool_v = kc.reshape(B * 4, 8, KV, D), vc.reshape(B * 4, 8, KV, D)
    bt = torch.arange(B * 4, dtype=torch.int32).reshape(B, 4)
    out = ops.flash_decode_paged(q, pool_k, pool_v, bt, lengths, scale=0.25)
    torch.testing.assert_close(
        out, ref.flash_decode_paged_ref(q, pool_k, pool_v, bt, lengths,
                                        scale=0.25), rtol=0, atol=0)
    assert ops.launches == before
    assert set(ops.launches) == {"flash_decode", "flash_decode_paged",
                                 "prefill_attention", "flash_attention",
                                 "fused_logprob_fwd", "fused_logprob_bwd",
                                 "ssd_scan"}


def test_unsupported_device_raises():
    """A meta tensor (the dry-run's trace) takes the plain version's shapes
    and runs nothing; a DTensor is refused (a kernel takes local shards,
    `shardctx.local_call`)."""
    from torch_twin import fake_dtensor

    q = torch.zeros(1, 4, 16, device="meta")
    kc = torch.zeros(1, 8, 2, 16, device="meta")
    lengths = torch.ones(1, dtype=torch.int32, device="meta")
    table = torch.ones((1, 1), dtype=torch.int32, device="meta")
    for out in (ops.flash_decode(q, kc, kc, lengths, scale=0.25),
                ops.flash_decode_paged(q, kc, kc, table, lengths,
                                       scale=0.25)):
        assert out.device.type == "meta" and out.shape == (1, 4, 16)
    with fake_dtensor(torch.zeros(1, 4, 16)) as dq:
        ck = torch.zeros(1, 8, 2, 16)
        with pytest.raises(TypeError, match="local tensors"):
            ops.flash_decode(dq, ck, ck, torch.ones(1, dtype=torch.int32),
                             scale=0.25)
        with pytest.raises(TypeError, match="local tensors"):
            ops.flash_decode_paged(dq, ck, ck,
                                   torch.ones((1, 1), dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32),
                                   scale=0.25)
