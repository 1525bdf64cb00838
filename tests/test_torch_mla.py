"""DeepSeek-V3's multi-head latent attention (MLA) and multi-token-prediction
(MTP) head in the port against the JAX package's, on the CPU, and the
geometry of `prefill_attention`'s wide instance (absorbed MLA's 576 / 512
head dims).

Config: `smoke_config(get_config("deepseek-v3-671b"))`, the JAX package's
smoke dims (2 layers: one dense of d_ff 128, one MoE of 4 experts top 2 of
d_ff 64 and a shared expert; d 256, 4 heads, q_lora 64, kv_lora 32, nope
32, rope 16, v 32; the MTP head; vocab 512; float32), and the port's config
with the same fields. Both packages start from the same converted weights
and get the same numpy inputs.

Tolerances, float32: every layer and model path against the JAX package's
within atol 1e-5, as `test_torch_model.py` and `test_torch_moe.py`; the
absorbed chunked prefill against the JAX function with its Pallas kernel in
interpret mode (Dk 48 = kv_lora + rope, Dv 32) within 1e-5; the fused MTP
stats against the `mtp_logits` oracle within atol and rtol 2e-4, the
tolerance of the JAX package's own test (`tests/test_fused_logprob.py:146`).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.sharding import tree_values
from repro_torch import get_config
from repro_torch.configs.base import PORT_OWN_FIELDS, kv_cache_specs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import model as M

ATOL = 1e-5
MTP_TOL = 2e-4
CPU = {"device": "cpu"}


def _configs(**kw):
    jcfg = dataclasses.replace(smoke_config(jax_get_config(
        "deepseek-v3-671b")), **kw)
    tcfg = get_config("deepseek-v3-671b")
    same = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcfg)
            if f.name not in ("dtype",) + PORT_OWN_FIELDS}
    return jcfg, dataclasses.replace(tcfg, dtype=torch.float32, **same)


@functools.lru_cache(maxsize=None)
def _numpy_tree(seed):
    return jax.tree.map(np.asarray, tree_values(
        JM.init_params(_configs()[0], jax.random.PRNGKey(seed))))


@pytest.fixture(scope="module")
def mla():
    jcfg, tcfg = _configs()
    tree = _numpy_tree(0)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, **CPU))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_value, atol=ATOL, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_value, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def _layer(jp, tp, l=0):
    """Layer 0's attention leaves of both trees (the dense group's)."""
    return (jax.tree.map(lambda a: a[l], jp["groups"][0]["attn"]),
            {k: v[l] for k, v in tp["groups"][0]["attn"].items()})


def _x(rng, B, S, d):
    return rng.standard_normal((B, S, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
def test_mla_forward_matches_jax(mla, packed):
    """The naive expansion through the plain blocked attention, with and
    without a packed batch's segment ids; the latent and rope key it
    returns for the cache."""
    jcfg, tcfg, jp, tp = mla
    ja, ta = _layer(jp, tp)
    rng = np.random.default_rng(1)
    B, S = 2, 24
    x = _x(rng, B, S, tcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    seg = np.repeat(np.array([[1, 2, 3]]), S // 3, axis=1).repeat(B, 0) \
        if packed else None
    jy, (jc, jr) = JA.mla_forward(ja, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                  None if seg is None else jnp.asarray(seg),
                                  return_kv=True)
    y, (c, r) = TA.mla_forward(ta, _t(x), _t(pos).long(), tcfg,
                               None if seg is None else _t(seg).long(),
                               return_kv=True)
    assert tuple(c.shape) == (B, S, tcfg.kv_lora_rank)
    assert tuple(r.shape) == (B, S, tcfg.qk_rope_dim)
    _close(y, jy)
    _close(c, jc)
    _close(r, jr)


def _cache(rng, B, CL, cfg):
    return (rng.standard_normal((B, CL, cfg.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((B, CL, cfg.qk_rope_dim)).astype(np.float32))


def _pool(view, bt, n_pages, ps, rng):
    """A page pool holding `view` (B, NB*PS, ...) at the pages of `bt`
    (B,NB), noise elsewhere."""
    pool = rng.standard_normal((n_pages, ps) + view.shape[2:]).astype(
        np.float32)
    B, NB = bt.shape
    pool[bt.reshape(-1)] = view.reshape((B * NB, ps) + view.shape[2:])
    return pool


@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_mla_decode_matches_jax(mla, cache):
    """Absorbed one-token decode against a compressed cache of ragged
    lengths (masked by count), the slot cache and the page pool through a
    shuffled block table: the output and the written latent."""
    jcfg, tcfg, jp, tp = mla
    ja, ta = _layer(jp, tp)
    rng = np.random.default_rng(2)
    B, CL, ps = 3, 32, 8
    ckv, krope = _cache(rng, B, CL, tcfg)
    x = _x(rng, B, 1, tcfg.d_model)
    idx = np.array([0, 13, 31], np.int32)
    pos = idx[:, None]
    bt = None
    if cache == "paged":
        bt = rng.permutation(np.arange(1, 1 + B * CL // ps)).reshape(
            B, CL // ps).astype(np.int32)
        n_pages = B * CL // ps + 3
        ckv, krope = (_pool(v, bt, n_pages, ps, rng) for v in (ckv, krope))
    jy, (jc, jr) = JA.mla_decode(
        ja, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ckv),
        jnp.asarray(krope), jnp.asarray(idx), jcfg, ring=False,
        block_tables=None if bt is None else jnp.asarray(bt))
    tc, tr = _t(ckv), _t(krope)
    y = TA.mla_decode(ta, _t(x), _t(pos).long(), tc, tr, _t(idx).long(),
                      tcfg, ring=False,
                      block_tables=None if bt is None else _t(bt))
    _close(y, jy)
    _close(tc, jc)
    _close(tr, jr)


@pytest.mark.parametrize("cache,offset", [("slots", 0), ("slots", 16),
                                          ("paged", 16)])
def test_mla_prefill_chunk_matches_jax_pallas(mla, cache, offset):
    """The absorbed chunk through `prefill_attention` as one KV head (Dk 48,
    Dv 32; its plain version here) against the JAX function with the Pallas
    kernel in interpret mode; rows masked out of the write keep their
    latent."""
    jcfg, tcfg, jp, tp = mla
    jcfg = dataclasses.replace(jcfg, use_pallas=True, pallas_interpret=True)
    ja, ta = _layer(jp, tp)
    rng = np.random.default_rng(3 + offset)
    B, C, CL, ps = 3, 8, 32, 8
    ckv, krope = _cache(rng, B, CL, tcfg)
    x = _x(rng, B, C, tcfg.d_model)
    pos = np.broadcast_to(offset + np.arange(C, dtype=np.int32)[None], (B, C))
    mask = np.ones((B, C), bool)
    mask[1] = False
    mask[2, 5:] = False
    bt = None
    if cache == "paged":
        bt = rng.permutation(np.arange(1, 1 + B * CL // ps)).reshape(
            B, CL // ps).astype(np.int32)
        ckv, krope = (_pool(v, bt, B * CL // ps + 2, ps, rng)
                      for v in (ckv, krope))
    jy, (jc, jr) = JA.mla_prefill_chunk(
        ja, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ckv),
        jnp.asarray(krope), offset, jnp.asarray(mask), jcfg,
        block_tables=None if bt is None else jnp.asarray(bt))
    tc, tr = _t(ckv), _t(krope)
    y = TA.mla_prefill_chunk(ta, _t(x), _t(pos).long(), tc, tr, offset,
                             _t(mask), tcfg,
                             block_tables=None if bt is None else _t(bt))
    _close(y, jy)
    _close(tc, jc)
    _close(tr, jr)


# ---------------------------------------------------------------------------
# the model: the dense group, the MoE group and the MTP head
# ---------------------------------------------------------------------------

def _tokens(rng, B, S, vocab):
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return toks, np.ascontiguousarray(pos)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_jax(fused):
    """The model forward over the leading dense layer and the MoE layer:
    logits and `mtp_logits` (unfused), or the fused stats and the MTP
    head's `mtp_token_logprobs`, `mtp_lse` and `mtp_entropy` through the
    same fused call (and no `mtp_logits`); values, the aux loss and the
    latent cache (L,B,S,r|rope)."""
    jcfg, tcfg = _configs(fused_loss=fused)
    tree = _numpy_tree(0)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tcfg,
                                                                **CPU)
    assert M.layer_groups(tcfg) == [("dense", 1), ("moe", 1)]
    rng = np.random.default_rng(4)
    B, S = 2, 24
    toks, pos = _tokens(rng, B, S, tcfg.vocab_size)
    kw, tkw = {}, {}
    if fused:
        tgt = np.concatenate([toks[:, 1:], toks[:, -1:]], axis=1)
        kw["loss_targets"], tkw["loss_targets"] = jnp.asarray(tgt), \
            _t(tgt).long()
    jout = JM.forward(jp, jnp.asarray(toks), jnp.asarray(pos), jcfg,
                      return_cache=True, **kw)
    out = M.forward(tp, _t(toks).long(), _t(pos).long(), tcfg,
                    return_cache=True, **tkw)
    keys = ({"token_logprobs", "lse", "entropy", "mtp_token_logprobs",
             "mtp_lse", "mtp_entropy"} if fused else {"logits", "mtp_logits"})
    assert keys | {"values", "aux_loss", "cache"} <= set(out)
    assert ("mtp_logits" in out) == (not fused)
    for k in keys | {"values", "aux_loss"}:
        _close(out[k], jout[k], msg=k)
    if not fused:
        assert tuple(out["mtp_logits"].shape) == (B, S - 1, tcfg.vocab_size)
    assert set(out["cache"]) == set(jout["cache"]) == {"c_kv", "k_rope"}
    for k in out["cache"]:
        _close(out["cache"][k], jout["cache"][k], msg=k)


def test_mtp_fused_stats_match_the_logits_oracle():
    """The port's twin of the JAX package's
    `test_mtp_fused_head_matches_logits_oracle`: the fused MTP stats equal
    the log-softmax, logsumexp and entropy of the unfused forward's
    `mtp_logits` (row t scoring token t+2, the last row a dead pad)."""
    _, tcfg = _configs(fused_loss=True)
    tp = params_from_numpy(_numpy_tree(0), tcfg, **CPU)
    rng = np.random.default_rng(7)
    toks, pos = _tokens(rng, 2, 16, tcfg.vocab_size)
    tgt = np.concatenate([toks[:, 1:], toks[:, -1:]], axis=1)
    out = M.forward(tp, _t(toks).long(), _t(pos).long(), tcfg,
                    loss_targets=_t(tgt).long())
    assert "mtp_logits" not in out
    logits = M.forward(tp, _t(toks).long(), _t(pos).long(),
                       dataclasses.replace(tcfg, fused_loss=False)
                       )["mtp_logits"].float()
    ls = torch.log_softmax(logits, -1)
    mtp_tgt = _t(np.concatenate([toks[:, 2:], toks[:, -1:]], axis=1)).long()
    lse = torch.logsumexp(logits, -1)
    want = {"mtp_token_logprobs": ls.gather(-1, mtp_tgt[..., None])[..., 0],
            "mtp_lse": lse,
            "mtp_entropy": lse - (torch.softmax(logits, -1) * logits).sum(-1)}
    for k, v in want.items():
        np.testing.assert_allclose(out[k].numpy(), v.numpy(), atol=MTP_TOL,
                                   rtol=MTP_TOL, err_msg=k)


def test_decode_step_and_prefill_chunk_match_jax(mla):
    """One decode step from a cache of ragged lengths, slot and paged, and
    two prefill chunks with a partial admit mask, through both layer kinds:
    logits and every latent leaf."""
    jcfg, tcfg, jp, tp = mla
    rng = np.random.default_rng(5)
    B, T = 3, 32
    init = {k: rng.standard_normal(shape).astype(np.float32)
            for k, (shape, _) in kv_cache_specs(tcfg, B, T).items()}
    assert set(init) == {"c_kv", "k_rope"}
    toks = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    idx = np.array([3, 17, 30], np.int32)
    tcache = {k: _t(v) for k, v in init.items()}
    jd = JM.decode_step(jp, jnp.asarray(toks[:, :1]), jnp.asarray(idx[:, None]),
                        {k: jnp.asarray(v) for k, v in init.items()},
                        jnp.asarray(idx), jcfg, ring=False)
    d = M.decode_step(tp, _t(toks[:, :1]).long(), _t(idx[:, None]).long(),
                      tcache, _t(idx).long(), tcfg, ring=False)
    _close(d["logits"], jd["logits"])
    for k in tcache:
        _close(tcache[k], jd["cache"][k], msg=k)
    # the same step on a page pool (page 8, shuffled table)
    ps = 8
    bt = rng.permutation(np.arange(1, 1 + B * T // ps)).reshape(
        B, T // ps).astype(np.int32)
    pools = {k: torch.cat([_t(_pool(init[k][l], bt, B * T // ps + 1, ps,
                                    rng))[None]
                           for l in range(tcfg.n_layers)])
             for k in init}
    dp = M.decode_step(tp, _t(toks[:, :1]).long(), _t(idx[:, None]).long(),
                       pools, _t(idx).long(), tcfg, ring=False,
                       block_tables=_t(bt))
    assert torch.equal(dp["logits"], d["logits"])
    for k in pools:
        assert torch.equal(pools[k][:, torch.from_numpy(bt).long()]
                           .flatten(2, 3), tcache[k]), k
    # two 16-token prefill chunks, row 1 not admitted
    plen = np.array([10, 30, 25], np.int32)
    admit = np.array([True, False, True])
    tcache = {k: _t(v) for k, v in init.items()}
    jcache = {k: jnp.asarray(v) for k, v in init.items()}
    for off in (0, 16):
        jcache = JM.prefill_chunk(jp, jnp.asarray(toks), jnp.asarray(plen),
                                  off, jnp.asarray(admit), jcache, jcfg,
                                  chunk=16)
        M.prefill_chunk(tp, _t(toks).long(), _t(plen).long(), off,
                        _t(admit), tcache, tcfg, chunk=16)
    for k in tcache:
        _close(tcache[k], jcache[k], msg=k)
        np.testing.assert_array_equal(tcache[k][:, 1].numpy(), init[k][:, 1])


# ---------------------------------------------------------------------------
# prefill_attention's wide instance: the geometry, no card needed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kernel,rows,keys,stages,smem", [
    # 1024 of slack, 9 Q panels of 64 rows, the barriers, two stages of
    # 9 K and 8 V panels of 32 keys
    (torch.bfloat16, "tc-wide", 64, 32, 2,
     1024 + 9 * 64 * 128 + 64 + 2 * 17 * 32 * 128),
    # 16 rows and 32-key tiles: q, k (+1 column), v, s, acc, m / l / corr
    (torch.float32, "cuda-core", 16, 32, 1,
     4 * (16 * 576 + 32 * 577 + 32 * 512 + 16 * 32 + 16 * 512 + 48)),
])
def test_wide_prefill_geometry(dtype, kernel, rows, keys, stages, smem):
    """Absorbed MLA's head dims at DeepSeek-V3's widths (Dk 512 + 64, Dv
    512) fit a block's shared memory in both dtypes, where the 128-row
    tensor-core kernel and the 32-row float32 one do not."""
    geo = ops._prefill_geometry(576, 512, dtype)
    assert geo == (kernel, rows, keys, stages, smem)
    assert geo.smem <= ops._SMEM_LIMIT == 232448
    assert ops._smem_bytes(32, 576, 512) > ops._SMEM_LIMIT
    with pytest.raises(ValueError, match="up to 256"):
        ops._tc_geometry(576, 512)
    # the smoke dims and the dense shapes keep the 128-row kernels
    assert ops._prefill_geometry(48, 32, dtype).kernel == (
        "tc" if dtype == torch.bfloat16 else "cuda-core")
    assert ops._prefill_geometry(128, 128, dtype)[1:3] == (
        (128, 64) if dtype == torch.bfloat16 else (32, 64))


@pytest.mark.parametrize("dk,dv,dtype,match", [
    (592, 512, torch.bfloat16, r"up to \(576, 512\)"),
    (576, 528, torch.bfloat16, r"up to \(576, 512\)"),
    (584, 512, torch.bfloat16, "multiples of 16"),
    (72, 64, torch.bfloat16, "multiples of 16 up to 256"),
    (2048, 2048, torch.float32, "shared memory"),
    (576, 510, torch.float32, "multiples of 4"),
])
def test_wide_prefill_refuses_what_it_does_not_take(dk, dv, dtype, match):
    with pytest.raises(ValueError, match=match):
        ops._prefill_geometry(dk, dv, dtype)
