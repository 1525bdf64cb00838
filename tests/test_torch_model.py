"""The port's model layer (`repro_torch.models`, `repro_torch.convert`)
against the JAX package's, on the CPU, at the tiny dense config (2 layers,
d 64).

Both sides start from the same weights (`M.init_params` -> numpy -> torch)
and get the same numpy inputs. The JAX side runs with `use_pallas=True` (its
Pallas kernels in interpret mode; the shapes are chosen so they engage:
S % 128 == 0 for flash_attention, CL % 64 == 0 for flash_decode) and with
`use_pallas=False` (its jnp twins). Tolerance: atol 1e-5 in float32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import config as jax_tiny
from repro.core import events
from repro.models import layers as JL
from repro.models import model as JM
from repro.sharding import tree_values
from repro_torch.configs import tiny as port_tiny
from repro_torch.configs.base import PORT_OWN_FIELDS
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import weights as W
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

VOCAB = 40
ATOL = 1e-5


def _configs(use_pallas=False, **kw):
    """(JAX config, port config) of the same tiny model."""
    jcfg = dataclasses.replace(jax_tiny(vocab_size=VOCAB, d_model=64),
                               use_pallas=use_pallas, **kw)
    tcfg = dataclasses.replace(port_tiny.config(vocab_size=VOCAB, d_model=64),
                               **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _numpy_params(tie: bool = True):
    jcfg, _ = _configs(tie_embeddings=tie)
    jp = tree_values(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, jp)


def _pair_params(tcfg, tie: bool = True):
    tree = _numpy_params(tie)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_value, atol=ATOL, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_value, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny", "llama3-8b", "granite-3-2b"])
def test_configs_match_jax(arch):
    """The port's copies agree with the JAX registry on every field they
    share, the dtype mapped; the cache specs agree too."""
    from repro.configs import get_config as jax_get
    from repro.configs.base import kv_cache_specs as jax_specs
    from repro_torch.configs import get_config, kv_cache_specs
    jcfg = jax_tiny() if arch == "tiny" else jax_get(arch)
    tcfg = get_config(arch)
    for f in dataclasses.fields(tcfg):
        if f.name in PORT_OWN_FIELDS:    # the port's own, at their defaults
            assert getattr(tcfg, f.name) == f.default, f.name
            continue
        want = getattr(jcfg, f.name)
        if f.name == "dtype":
            want = {jnp.float32: torch.float32,
                    jnp.bfloat16: torch.bfloat16}[want]
        assert getattr(tcfg, f.name) == want, f.name
    for variant in ({}, {"attention_variant": "sliding_window",
                         "sliding_window": 64}):
        j = jax_specs(dataclasses.replace(jcfg, **variant), 3, 256)
        t = kv_cache_specs(dataclasses.replace(tcfg, **variant), 3, 256)
        assert {k: v.shape for k, v in j.items()} == \
            {k: shape for k, (shape, _) in t.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    atol = ATOL if dtype == "float32" else 2e-2
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5))
    jx, tx = jnp.asarray(x, jdt), _t(x).to(tdt)
    _close(TL.rms_norm(tx, _t(scale).to(tdt), 1e-6),
           JL.rms_norm(jx, jnp.asarray(scale, jdt), 1e-6), atol)
    for theta in (1e4, 5e5):
        out = TL.apply_rope(tx, _t(pos), theta)
        assert out.dtype == tdt
        _close(out, JL.apply_rope(jx, jnp.asarray(pos), theta), atol)
        # no heads dimension
        _close(TL.apply_rope(tx[:, :, 0], _t(pos), theta),
               JL.apply_rope(jx[:, :, 0], jnp.asarray(pos), theta), atol)
    w = [rng.standard_normal(s).astype(np.float32) * 0.1
         for s in ((32, 48), (32, 48), (48, 32))]
    _close(TL.swiglu(tx, *[_t(a).to(tdt) for a in w]),
           JL.swiglu(jx, *[jnp.asarray(a, jdt) for a in w]), atol)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tie,dtype", [(True, "float32"),
                                       (False, "bfloat16")])
def test_params_round_trip_and_layout(tie, dtype):
    """numpy -> torch -> numpy is exact, the port's own initialiser makes
    the JAX tree's shapes and dtypes leaf for leaf, and both packages
    flatten the tree in the same order, so their streamed-update span
    tables and checksums agree."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg, tcfg = _configs(tie_embeddings=tie, dtype=jdt)
    tcfg = dataclasses.replace(tcfg, dtype=tdt)
    jtree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(1))))
    params = params_from_numpy(jtree, tcfg, device="cpu")
    back = params_to_numpy(params)
    jl, jdef = jax.tree_util.tree_flatten(jtree)
    bl, bdef = jax.tree_util.tree_flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))

    own = TM.init_params(tcfg, seed=3, device="cpu")
    tl, _ = W.tree_flatten(own)
    assert [(tuple(t.shape), t.dtype) for t in tl] == \
        [(tuple(t.shape), t.dtype) for t in W.tree_flatten(params)[0]]
    assert [tuple(t.shape) for t in tl] == [a.shape for a in jl]
    for n in (1, 3, 8):
        spans = W.chunk_spans(tl, n)
        assert spans == events.chunk_spans(jl, n)
        assert W.span_bytes(tl, spans) == events.span_bytes(jl, spans)
    assert W.tree_bytes(own) == events.tree_bytes(jtree)


def test_params_from_numpy_rejects_a_wrong_tree():
    _, tcfg = _configs()
    tree = dict(_numpy_params())
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({k: v for k, v in tree.items() if k != "embed"},
                          tcfg, device="cpu")
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# forward, decode_step, prefill_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(use_pallas):
    jcfg, tcfg = _configs(use_pallas)
    jp, tp = _pair_params(tcfg)
    B, S = 2, 128                      # S % 128 == 0: the Pallas kernel runs
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout = jax.jit(functools.partial(JM.forward, cfg=jcfg, return_cache=True))(
        jp, jnp.asarray(tokens), jnp.asarray(pos))
    tout = TM.forward(tp, _t(tokens).long(), _t(pos).long(), tcfg,
                      return_cache=True)
    _close(tout["logits"], jout["logits"], msg="logits")
    _close(tout["values"], jout["values"], msg="values")
    for k in ("k", "v"):
        assert tuple(tout["cache"][k].shape) == jout["cache"][k].shape
        _close(tout["cache"][k], jout["cache"][k], msg=k)
    # the head is skipped on request; the cache is unchanged
    nohead = TM.forward(tp, _t(tokens).long(), _t(pos).long(), tcfg,
                        return_cache=True, logits=False)
    assert "logits" not in nohead
    for k in ("k", "v"):
        torch.testing.assert_close(nohead["cache"][k], tout["cache"][k],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("use_pallas,ring", [(False, False), (True, False),
                                             (False, True)])
def test_decode_step_matches_jax(use_pallas, ring):
    jcfg, tcfg = _configs(use_pallas)
    jp, tp = _pair_params(tcfg)
    L, B, CL, KV, D = 2, 3, 64, 2, 32    # CL % 64 == 0: flash_decode runs
    rng = np.random.default_rng(3)
    cache = {k: rng.standard_normal((L, B, CL, KV, D)).astype(np.float32)
             for k in ("k", "v")}
    # per-slot write positions; a ring wraps them mod CL
    index = np.array([0, 17, 63] if not ring else [64, 81, 200], np.int32)
    tokens = rng.integers(0, VOCAB, (B, 1)).astype(np.int32)
    jout = JM.decode_step(jp, jnp.asarray(tokens), jnp.asarray(index[:, None]),
                          {k: jnp.asarray(v) for k, v in cache.items()},
                          jnp.asarray(index), jcfg, ring=ring)
    tcache = {k: _t(v) for k, v in cache.items()}
    tout = TM.decode_step(tp, _t(tokens).long(), _t(index[:, None]).long(),
                          tcache, _t(index).long(), tcfg, ring=ring)
    _close(tout["logits"], jout["logits"], msg="logits")
    _close(tout["values"], jout["values"], msg="values")
    for k in ("k", "v"):
        assert tout["cache"][k] is tcache[k]      # updated in place
        _close(tcache[k], jout["cache"][k], msg=k)


@pytest.mark.parametrize("use_pallas,window", [(False, 0), (True, 0),
                                               (False, 32), (True, 32)])
def test_prefill_chunk_matches_jax(use_pallas, window):
    """One chunk into a full-length (CL = T = 64) or a ring (CL = 32,
    chunk past the wrap) cache; rows not admitted keep their cache."""
    kw = dict(attention_variant="sliding_window", sliding_window=window) \
        if window else {}
    jcfg, tcfg = _configs(use_pallas, **kw)
    jp, tp = _pair_params(tcfg)
    L, B, T, KV, D, C = 2, 3, 64, 2, 32, 16
    CL = window or T
    offset = 48 if window else 16
    rng = np.random.default_rng(4)
    cache = {k: rng.standard_normal((L, B, CL, KV, D)).astype(np.float32)
             for k in ("k", "v")}
    tokens = rng.integers(0, VOCAB, (B, T)).astype(np.int32)
    plen = np.array([60, 20, 55], np.int32)
    admit = np.array([True, False, True])
    jnew = JM.prefill_chunk(jp, jnp.asarray(tokens), jnp.asarray(plen), offset,
                            jnp.asarray(admit),
                            {k: jnp.asarray(v) for k, v in cache.items()},
                            jcfg, chunk=C)
    tcache = {k: _t(v) for k, v in cache.items()}
    out = TM.prefill_chunk(tp, _t(tokens).long(), _t(plen).long(), offset,
                           _t(admit), tcache, tcfg, chunk=C)
    assert set(out) == {"cache"} and out["cache"] is tcache
    for k in ("k", "v"):
        _close(tcache[k], jnew[k], msg=k)
        np.testing.assert_array_equal(tcache[k][:, 1].numpy(),
                                      cache[k][:, 1])


def test_prefill_chunk_logits_match_forward():
    """A first chunk's logits (the check path `logits=True`) equal the
    full-sequence forward's on the same positions."""
    _, tcfg = _configs()
    _, tp = _pair_params(tcfg)
    B, T, C = 2, 64, 16
    rng = np.random.default_rng(5)
    tokens = _t(rng.integers(0, VOCAB, (B, T))).long()
    cache = {k: torch.zeros(2, B, T, 2, 32) for k in ("k", "v")}
    out = TM.prefill_chunk(tp, tokens, torch.full((B,), T), 0,
                           torch.ones(B, dtype=torch.bool), cache, tcfg,
                           chunk=C, logits=True)
    ref = TM.forward(tp, tokens[:, :C],
                     torch.arange(C)[None].expand(B, C), tcfg)
    torch.testing.assert_close(out["logits"], ref["logits"], rtol=0,
                               atol=ATOL)
    torch.testing.assert_close(out["values"], ref["values"], rtol=0,
                               atol=ATOL)
