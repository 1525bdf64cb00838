"""The port's Mamba2 (SSM) modules against the JAX package's, on the CPU:
the plain `ssd_scan` against the Pallas kernel (interpret mode) and its jnp
reference, the SSD block's pieces (`ssd_chunked`, the causal conv,
`ssm_forward`, `ssm_decode`) and the model's forward, decode step and
chunked prefill.

Config: `smoke_config(get_config("mamba2-2.7b"))` on the JAX side (2
layers, d 256, 16 SSM heads of 32, one group, state 16, chunk 16, vocab
512, float32) and its twin built with `dataclasses.replace` on the port's
side. Both start from the same weights (JAX `init_params` -> numpy ->
`params_from_numpy`) and get the same numpy inputs from a seed.

Tolerances: the port's plain path against the JAX jnp path, atol 1e-5 in
float32, with 1e-5 relative besides where the scan gets unit-normal inputs
and returns values up to ~10 (float32 sums in another order differ there
by a few ulps); against the Pallas `ssd_scan` the reference's own
tolerances (`tests/test_kernels.py`: atol 1e-4 / rtol 1e-3 in float32,
5e-2 in bfloat16), the kernel reassociating the recurrence across chunks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config
from repro.configs.base import kv_cache_specs as jax_kv_specs
from repro.configs.base import paged_cache_specs as jax_paged_specs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.sharding import tree_values
from repro_torch.configs import get_config
from repro_torch.configs.base import kv_cache_specs, paged_cache_specs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.models import ssm

ATOL = 1e-5
JCFG = smoke_config(jax_get_config("mamba2-2.7b"))
TCFG = dataclasses.replace(
    get_config("mamba2-2.7b"), n_layers=2, d_model=256, vocab_size=512,
    ssm_head_dim=32, ssm_state=16, ssm_chunk=16, dtype=torch.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_value, atol=ATOL, rtol=0.0, msg=""):
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(jax_value, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


_TREE = []


def _numpy_params():
    if not _TREE:
        _TREE.append(jax.tree.map(np.asarray, tree_values(
            JM.init_params(JCFG, jax.random.PRNGKey(0)))))
    return _TREE[0]


def _pair_params():
    tree = _numpy_params()
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, TCFG, device="cpu"))


def _layer0():
    """The first layer's SSM leaves, as numpy."""
    return {k: v[0] for k, v in _numpy_params()["groups"][0]["ssm"].items()}


# ---------------------------------------------------------------------------
# ssd_scan: the plain version against the Pallas kernel and its reference
# ---------------------------------------------------------------------------

def _scan_inputs(b, l, h, p, g, n, seed=0):
    """float32 numpy inputs in the JAX tests' law: x, B, C normal, dt
    softplus(normal), A = -exp(normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (1, 64, 2, 16, 1, 8, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 96, 6, 16, 3, 8, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_ref_matches_pallas_and_its_reference(b, l, h, p, g, n,
                                                       chunk, dtype):
    """y and the final state in the kernel's (b,h,n,p) layout, against the
    Pallas kernel (interpret mode) on the same inputs and the JAX reference
    on the same values in float32, as `tests/test_kernels.py` holds the
    Pallas kernel; heads repeat over 2 and 3 groups."""
    x, dt, A, B, C = _scan_inputs(b, l, h, p, g, n)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    # x, B and C rounded to the dtype, as jax.random draws them there
    x, B, C = (_t(a).to(td).float().numpy() for a in (x, B, C))
    y, st = ref.ssd_scan_ref(_t(x).to(td), _t(dt), _t(A), _t(B).to(td),
                             _t(C).to(td), chunk=chunk)
    assert y.dtype == td and tuple(y.shape) == (b, l, h, p)
    assert st.dtype == torch.float32 and tuple(st.shape) == (b, h, n, p)
    jy, jst = jops.ssd_scan(jnp.asarray(x).astype(jd), jnp.asarray(dt),
                            jnp.asarray(A), jnp.asarray(B).astype(jd),
                            jnp.asarray(C).astype(jd), chunk=chunk)
    ey, est = jref.ssd_scan_ref(jnp.asarray(x), jnp.asarray(dt),
                                jnp.asarray(A), jnp.asarray(B),
                                jnp.asarray(C), chunk=chunk)
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=1e-3)
    for want in ((jy, jst), (ey, est)):
        _close(y, want[0], **tol)
        _close(st, want[1], **tol)


def test_ssd_scan_state_carries_across_chunks():
    """A signal in chunk 0 reaches the outputs of the last chunk."""
    b, l, h, p, g, n, chunk = 1, 64, 1, 8, 1, 8, 16
    x = torch.zeros((b, l, h, p))
    x[0, 3] = 1.0
    dt = torch.full((b, l, h), 0.05)
    A = -torch.ones((h,)) * 0.01
    B = torch.ones((b, l, g, n))
    C = torch.ones((b, l, g, n))
    y, _ = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert float(y[0, -1].abs().max()) > 1e-4


def test_ssd_scan_on_cpu_takes_the_plain_version():
    """CPU tensors run `ssd_scan_ref` and count no launch; strided views
    (the model's slices of one conv output) read as their copies do."""
    x, dt, A, B, C = _scan_inputs(2, 32, 4, 8, 2, 8, seed=3)
    xbc = torch.cat([_t(x).reshape(2, 32, 32), _t(B).reshape(2, 32, 16),
                     _t(C).reshape(2, 32, 16)], dim=-1)
    xs = xbc[..., :32].reshape(2, 32, 4, 8)
    Bv = xbc[..., 32:48].reshape(2, 32, 2, 8)
    Cv = xbc[..., 48:].reshape(2, 32, 2, 8)
    assert not xs.is_contiguous()
    ops.reset_launches()
    y, st = ops.ssd_scan(xs, _t(dt), _t(A), Bv, Cv, chunk=16)
    assert ops.launches["ssd_scan"] == 0
    ey, est = ref.ssd_scan_ref(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk=16)
    assert torch.equal(y, ey) and torch.equal(st, est)


def test_ssd_scan_unsupported_device_raises():
    x = torch.zeros(1, 16, 2, 8, device="meta")
    dt = torch.zeros(1, 16, 2, device="meta")
    B = torch.zeros(1, 16, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_scan(x, dt, torch.zeros(2, device="meta"), B, B, chunk=16)


@pytest.mark.parametrize("bad", ["chunk", "head_dim", "groups", "dt_dtype",
                                 "mixed_dtype", "shape"])
def test_ssd_scan_refuses_what_the_kernel_does_not_take(bad):
    x, dt, A, B, C = (_t(a) for a in _scan_inputs(1, 32, 4, 8, 2, 8))
    kw = dict(chunk=16)
    if bad == "chunk":
        kw["chunk"] = 12                      # l % chunk != 0
    elif bad == "head_dim":
        x = x[..., :6]                        # P not a multiple of 8
    elif bad == "groups":
        B, C = B[:, :, :1].expand(1, 32, 3, 8), C[:, :, :1].expand(1, 32, 3, 8)
    elif bad == "dt_dtype":
        dt = dt.double()
    elif bad == "mixed_dtype":
        B = B.to(torch.bfloat16)
    else:
        dt = dt[:, :16]
    err = TypeError if "dtype" in bad else ValueError
    with pytest.raises(err, match="ssd_scan"):
        ops.ssd_scan(x, dt, A, B, C, **kw)


# ---------------------------------------------------------------------------
# the SSD block's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l", [64, 40])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunked_matches_jax(l, carried):
    """With and without a carried-in state, for an l that is and one that
    is not a multiple of the chunk."""
    x, dt, A, B, C = _scan_inputs(2, l, 4, 8, 2, 8, seed=5)
    init = (np.random.default_rng(6).standard_normal((2, 4, 8, 8))
            .astype(np.float32) if carried else None)
    y, st = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), 16,
                            initial_state=None if init is None else _t(init))
    jy, jst = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                               16, initial_state=None if init is None
                               else jnp.asarray(init))
    _close(y, jy, rtol=1e-5)
    _close(st, jst, rtol=1e-5)


@pytest.mark.parametrize("left", [False, True])
def test_causal_conv_matches_jax(left):
    rng = np.random.default_rng(7)
    xbc = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    lf = rng.standard_normal((2, 3, 24)).astype(np.float32) if left else None
    out = ssm._causal_conv(_t(xbc), _t(w), _t(bias),
                           left=None if lf is None else _t(lf))
    jout = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                             jnp.asarray(bias),
                             left=None if lf is None else jnp.asarray(lf))
    _close(out, jout)


def _spy_kernel(monkeypatch):
    """Count the model's calls of `ops.ssd_scan` (the kernel gate)."""
    calls = []
    real = ssm.kops.ssd_scan

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(ssm.kops, "ssd_scan", spy)
    return calls


@pytest.mark.parametrize("S", [32, 20])
def test_ssm_forward_matches_jax_and_gates_the_kernel(monkeypatch, S):
    """The block's output and returned state against the JAX block with
    `use_pallas` off and on. S % chunk == 0 takes the kernel (its plain
    version here); S = 20 takes `ssd_chunked`, as in the reference; an
    input that requires grad takes `ssd_chunked` too."""
    lp = _layer0()
    x = np.random.default_rng(8).standard_normal((2, S, 256)).astype(
        np.float32)
    calls = _spy_kernel(monkeypatch)
    out, (conv, st) = ssm.ssm_forward({k: _t(v) for k, v in lp.items()},
                                      _t(x), TCFG, return_state=True)
    assert len(calls) == (1 if S % 16 == 0 else 0)
    for use_pallas in (False, True):
        jcfg = dataclasses.replace(JCFG, use_pallas=use_pallas)
        jout, (jconv, jst) = jssm.ssm_forward(
            jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jcfg,
            return_state=True)
        tol = dict(atol=2e-4, rtol=2e-4) if use_pallas and S % 16 == 0 \
            else {}
        _close(out, jout, **tol)
        _close(conv, jconv, **tol)
        _close(st, jst, **tol)
    calls.clear()
    xg = _t(x).requires_grad_(True)
    out_g = ssm.ssm_forward({k: _t(v) for k, v in lp.items()}, xg, TCFG)
    assert calls == []
    out_g.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    _close(out_g, out)


def test_ssm_forward_ragged_token_mask_matches_jax():
    """Chunked prefill's use: three 8-token calls thread the state, with
    prompts ending in the first, the second and the third call. Finished
    rows pass through with both states unchanged."""
    lp = _layer0()
    tp = {k: _t(v) for k, v in lp.items()}
    jp = jax.tree.map(jnp.asarray, lp)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 24, 256)).astype(np.float32)
    valid = np.array([5, 13, 24])
    k, ch = TCFG.d_conv, TCFG.d_inner + 2 * TCFG.ssm_state
    conv = rng.standard_normal((3, k - 1, ch)).astype(np.float32)
    ssd = rng.standard_normal((3, 16, 32, 16)).astype(np.float32)
    tstate, jstate = (_t(conv), _t(ssd)), (jnp.asarray(conv),
                                           jnp.asarray(ssd))
    for c in range(3):
        pos = np.arange(8 * c, 8 * c + 8)
        mask = (pos[None] < valid[:, None]).astype(np.float32)
        xc = x[:, 8 * c:8 * c + 8]
        out, new = ssm.ssm_forward(tp, _t(xc), TCFG, return_state=True,
                                   initial_state=tstate, token_mask=_t(mask))
        jout, jnew = jssm.ssm_forward(jp, jnp.asarray(xc), JCFG,
                                      return_state=True,
                                      initial_state=jstate,
                                      token_mask=jnp.asarray(mask))
        _close(out, jout)
        for a, b in zip(new, jnew):
            _close(a, b)
        done = mask.sum(1) == 0
        for a, b in zip(new, tstate):
            assert torch.equal(a[done], b[done])
        tstate, jstate = new, jnew


def test_ssm_decode_matches_jax():
    lp = _layer0()
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 1, 256)).astype(np.float32)
    conv = rng.standard_normal((3, 3, 512 + 32)).astype(np.float32)
    ssd = rng.standard_normal((3, 16, 32, 16)).astype(np.float32)
    out, (nconv, nssd) = ssm.ssm_decode({k: _t(v) for k, v in lp.items()},
                                        _t(x), _t(conv), _t(ssd), TCFG)
    jout, (jconv, jssd) = jssm.ssm_decode(
        jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jnp.asarray(conv),
        jnp.asarray(ssd), JCFG)
    _close(out, jout)
    _close(nconv, jconv)
    _close(nssd, jssd)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_param_and_cache_specs_match_jax():
    """The parameter tree converts leaf for leaf (shapes, dtypes) and the
    slot and paged cache specs equal the JAX package's at full width."""
    _, tp = _pair_params()
    tree = _numpy_params()
    assert set(tp["groups"][0]) == set(tree["groups"][0]) == {"norm1", "ssm"}
    for k, v in tp["groups"][0]["ssm"].items():
        assert tuple(v.shape) == tree["groups"][0]["ssm"][k].shape, k
    full_t = get_config("mamba2-2.7b")
    full_j = jax_get_config("mamba2-2.7b")
    for tspec, jspec in ((kv_cache_specs(full_t, 16, 512),
                          jax_kv_specs(full_j, 16, 512)),
                         (paged_cache_specs(full_t, 16, 512, 9, 64),
                          jax_paged_specs(full_j, 16, 512, 9, 64))):
        assert set(tspec) == set(jspec) == {"conv", "ssd"}
        for k, (shape, dtype) in tspec.items():
            assert shape == jspec[k].shape, k
            assert str(dtype).split(".")[-1] == str(jspec[k].dtype), k


def _tokens(B, S, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (B, S)).astype(np.int32),
            np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_cache_match_jax(monkeypatch, use_pallas):
    """Logits, values and the returned conv/SSD state against the JAX
    forward; S % chunk == 0, so every layer takes the kernel (the plain
    version on the CPU) in the port and, with use_pallas, the Pallas
    kernel in interpret mode in the JAX package."""
    jp, tp = _pair_params()
    toks, pos = _tokens(2, 32)
    calls = _spy_kernel(monkeypatch)
    out = M.forward(tp, _t(toks).long(), _t(pos).long(), TCFG,
                    return_cache=True)
    assert len(calls) == TCFG.n_layers
    jcfg = dataclasses.replace(JCFG, use_pallas=use_pallas)
    jout = JM.forward(jp, jnp.asarray(toks), jnp.asarray(pos), jcfg,
                      return_cache=True)
    tol = dict(atol=2e-4, rtol=2e-4) if use_pallas else {}
    _close(out["logits"], jout["logits"], **tol)
    _close(out["values"], jout["values"], **tol)
    assert set(out["cache"]) == set(jout["cache"]) == {"conv", "ssd"}
    for k in ("conv", "ssd"):
        assert tuple(out["cache"][k].shape) == jout["cache"][k].shape
        _close(out["cache"][k], jout["cache"][k], **tol)


def test_decode_step_from_prefilled_cache_matches_jax():
    jp, tp = _pair_params()
    toks, pos = _tokens(2, 32, seed=12)
    S = 31
    jpre = JM.forward(jp, jnp.asarray(toks[:, :S]), jnp.asarray(pos[:, :S]),
                      JCFG, return_cache=True)
    tpre = M.forward(tp, _t(toks[:, :S]).long(), _t(pos[:, :S]).long(),
                     TCFG, return_cache=True)
    jout = JM.decode_step(jp, jnp.asarray(toks[:, S:]),
                          jnp.asarray(pos[:, S:]), jpre["cache"],
                          jnp.full((2,), S, jnp.int32), JCFG)
    cache = tpre["cache"]
    out = M.decode_step(tp, _t(toks[:, S:]).long(), _t(pos[:, S:]).long(),
                        cache, torch.full((2,), S), TCFG)
    assert out["cache"] is cache                    # updated in place
    _close(out["logits"], jout["logits"])
    for k in ("conv", "ssd"):
        _close(cache[k], jout["cache"][k])


def test_prefill_chunk_with_partial_admit_matches_jax():
    """Two 16-token chunks over a (3, 32) buffer, rows 0 and 2 admitted:
    the admitted rows' state equals the JAX prefill's and row 1's state
    stays as it was, in place."""
    jp, tp = _pair_params()
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 512, (3, 32)).astype(np.int32)
    plen = np.array([10, 20, 30], np.int32)
    admit = np.array([True, False, True])
    specs = kv_cache_specs(TCFG, 3, 32)
    init = {k: rng.standard_normal(shape).astype(np.float32)
            for k, (shape, _) in specs.items()}
    tcache = {k: _t(v) for k, v in init.items()}
    jcache = {k: jnp.asarray(v) for k, v in init.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    for off in (0, 16):
        jcache = JM.prefill_chunk(jp, jnp.asarray(toks), jnp.asarray(plen),
                                  off, jnp.asarray(admit), jcache, JCFG,
                                  chunk=16)
        M.prefill_chunk(tp, _t(toks).long(), _t(plen).long(), off,
                        _t(admit), tcache, TCFG, chunk=16)
    for k in ("conv", "ssd"):
        assert tcache[k].data_ptr() == ptrs[k]
        _close(tcache[k], jcache[k])
        np.testing.assert_array_equal(tcache[k][:, 1].numpy(), init[k][:, 1])
