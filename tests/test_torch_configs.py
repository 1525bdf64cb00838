"""The port's configs and parameter trees against the JAX package's, and the
multimodal prefix (phi-3-vision, musicgen) through the forward and the
Trainer, on the CPU.

- The registry serves every config of the JAX package and the port's own
  (`PORT_ONLY`), and each of the first equals the JAX package's of the
  same name field by field (the dtype mapped; the port's own fields at
  their defaults), with the same analytic parameter count.
- `param_shapes` gives the JAX `param_defs` tree leaf for leaf (shape,
  dtype, init scale) at full size, for every config (deepseek-v3's MLA
  leaves and MTP head included); the JAX fields the port leaves out are
  the ones no config needs.
- The hybrid config's slot and paged cache specs hold the attention and
  the SSM leaves, and deepseek-v3's the latent `c_kv` and `k_rope` at full
  length, as the JAX package's do.
- The multimodal forward (`prefix_embeds` through `mm_proj`, shifted
  positions, segment 0 for the prefix of a packed batch, the prefix rows
  stripped from logits, values and the fused stats) at smoke size, float32,
  within atol 1e-5 of the JAX forward; one Trainer step with the prefix in
  its batch within the tolerances of `test_torch_trainer.py`.
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
from repro.configs.tiny import config as jax_tiny
from repro.core.trainer import Trainer as JaxTrainer
from repro.models import model as JM
from repro.models.layers import ParamDef
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro.sharding import tree_values
from repro_torch import AdamConfig, Trainer
from repro_torch.configs import ARCH_IDS, PORT_ONLY, get_config
from repro_torch.configs.base import (PORT_OWN_FIELDS, kv_cache_specs,
                                      paged_cache_specs)
from repro_torch.convert import params_from_numpy
from repro_torch.core.weights import tree_flatten
from repro_torch.data.packing import Rollout, pack
from repro_torch.models import model as M

ATOL = 1e-5
# the configs with a twin in the JAX package
TWIN_IDS = [a for a in ARCH_IDS if a not in PORT_ONLY]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _jax_config(arch):
    return jax_tiny() if arch == "tiny" else jax_get_config(arch)


def _port_config(jcfg, arch):
    """The port's config of `arch` with every field of the JAX `jcfg`."""
    tcfg = get_config(arch)
    same = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcfg)
            if f.name not in ("dtype",) + PORT_OWN_FIELDS}
    return dataclasses.replace(tcfg, dtype=DTYPES[jcfg.dtype], **same)


def test_registry_serves_every_config():
    from repro.configs import ARCH_IDS as JAX_IDS
    assert set(ARCH_IDS) == set(JAX_IDS) | {"tiny"} | set(PORT_ONLY)
    assert len(ARCH_IDS) == 12


@pytest.mark.parametrize("arch", TWIN_IDS)
def test_config_equals_jax_field_by_field(arch):
    jcfg, tcfg = _jax_config(arch), get_config(arch)
    for f in dataclasses.fields(tcfg):
        if f.name in PORT_OWN_FIELDS:
            assert getattr(tcfg, f.name) == f.default, f.name
            continue
        want = getattr(jcfg, f.name)
        if f.name == "dtype":
            want = DTYPES[want]
        assert getattr(tcfg, f.name) == want, f.name
    for prop in ("d_inner", "n_ssm_heads", "has_attention", "has_ssm",
                 "is_attention_free"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    for active in (False, True):
        assert tcfg.param_count(active) == jcfg.param_count(active)


def _flat_defs(tree, path=""):
    """{path: ParamDef} of the JAX package's `param_defs` tree."""
    if isinstance(tree, ParamDef):
        return {path: (tree.shape, DTYPES[tree.dtype], tree.scale)}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_defs(v, f"{path}/{k}"))
    return out


def _flat_shapes(tree, path=""):
    if isinstance(tree, tuple):
        shape, dtype, scale = tree
        return {path: (tuple(shape), dtype, scale)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_shapes(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("arch", TWIN_IDS)
def test_param_shapes_equal_the_jax_tree(arch):
    """Full size, no allocation: every leaf's shape, dtype and init scale
    (the float32 router of the MoE config, the hybrid's branch norms, the
    multimodal projector)."""
    jcfg, tcfg = _jax_config(arch), get_config(arch)
    want = _flat_defs(JM.param_defs(jcfg))
    got = _flat_shapes(M.param_shapes(tcfg))
    assert set(got) == set(want)
    for k in want:
        assert got[k][:2] == tuple(want[k][:2]), k
        assert got[k][2] == pytest.approx(want[k][2], rel=1e-12), k
    if tcfg.n_experts:
        # the MoE group follows the leading dense layers, if any
        g = len(M.layer_groups(tcfg)) - 1
        assert got[f"/groups/{g}/moe/router"][1] == torch.float32
    if tcfg.arch_type == "hybrid":
        assert "/groups/0/hyb_norm_a" in got and "/groups/0/ssm/D" in got
    if tcfg.modality != "text":
        assert got["/mm_proj"][0] == (tcfg.d_model, tcfg.d_model)
    if tcfg.use_mla:
        assert got["/groups/0/attn/wkv_a"][0] == (
            tcfg.n_dense_layers, tcfg.d_model,
            tcfg.kv_lora_rank + tcfg.qk_rope_dim)
        assert got["/mtp/layer/ffn/up"][0] == (1, tcfg.d_model,
                                               tcfg.dense_d_ff)


@pytest.mark.parametrize("arch", TWIN_IDS)
def test_smoke_params_convert_leaf_for_leaf(arch):
    """At smoke size, the JAX `init_params` tree converts into the port's
    tree and back with every leaf's shape and dtype."""
    jcfg = smoke_config(_jax_config(arch))
    tcfg = _port_config(jcfg, arch)
    tree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(0))))
    tp = params_from_numpy(tree, tcfg, device="cpu")
    jleaves, tleaves = jax.tree.leaves(tree), tree_flatten(tp)[0]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape
        assert b.dtype == DTYPES[jnp.dtype(a.dtype).type]
        np.testing.assert_array_equal(b.numpy(), a)


# JAX fields the port's config leaves out: the unread `router_aux_coef`,
# `hybrid_parallel` (arch_type "hybrid"), and the JAX-only switches (Pallas,
# interpret mode, scan unrolling)
_LEFT_OUT = {"router_aux_coef", "hybrid_parallel", "use_pallas",
             "pallas_interpret", "scan_unroll"}


@pytest.mark.parametrize("arch", TWIN_IDS)
def test_fields_left_out_are_not_needed(arch):
    """Each JAX field the port lacks holds, in every ported config, a value
    that the port's own fields already say."""
    jcfg, tcfg = _jax_config(arch), get_config(arch)
    port = {f.name for f in dataclasses.fields(tcfg)}
    assert {f.name for f in dataclasses.fields(jcfg)} - port == _LEFT_OUT
    assert jcfg.hybrid_parallel == (tcfg.arch_type == "hybrid")


def test_hybrid_cache_specs_hold_attention_and_ssm_leaves():
    tcfg, jcfg = get_config("hymba-1.5b"), jax_get_config("hymba-1.5b")
    for variant in ({}, {"attention_variant": "sliding_window",
                         "sliding_window": 256}):
        t, j = (dataclasses.replace(tcfg, **variant),
                dataclasses.replace(jcfg, **variant))
        for tspec, jspec in ((kv_cache_specs(t, 16, 512),
                              jax_kv_specs(j, 16, 512)),
                             (paged_cache_specs(t, 16, 512, 129, 64),
                              jax_paged_specs(j, 16, 512, 129, 64))):
            assert set(tspec) == set(jspec) == {"k", "v", "conv", "ssd"}
            for k, (shape, dtype) in tspec.items():
                assert shape == jspec[k].shape, k
                assert dtype == DTYPES[jnp.dtype(jspec[k].dtype).type], k


def test_mla_cache_specs_hold_the_latent_leaves():
    """deepseek-v3's slot and paged caches: the latent c_kv (r) and the
    shared rope key k_rope, at full length even with the sliding-window
    variant (the compressed cache keeps no ring), as the JAX package's."""
    tcfg, jcfg = (get_config("deepseek-v3-671b"),
                  jax_get_config("deepseek-v3-671b"))
    for variant in ({}, {"attention_variant": "sliding_window",
                         "sliding_window": 256}):
        t, j = (dataclasses.replace(tcfg, **variant),
                dataclasses.replace(jcfg, **variant))
        for tspec, jspec in ((kv_cache_specs(t, 16, 512),
                              jax_kv_specs(j, 16, 512)),
                             (paged_cache_specs(t, 16, 512, 129, 64),
                              jax_paged_specs(j, 16, 512, 129, 64))):
            assert set(tspec) == set(jspec) == {"c_kv", "k_rope"}
            for k, (shape, dtype) in tspec.items():
                assert shape == jspec[k].shape, k
                assert dtype == DTYPES[jnp.dtype(jspec[k].dtype).type], k
        assert kv_cache_specs(t, 16, 512)["c_kv"][0] == (61, 16, 512, 512)


# ---------------------------------------------------------------------------
# the multimodal prefix
# ---------------------------------------------------------------------------

def _pair(arch, **kw):
    jcfg = dataclasses.replace(smoke_config(jax_get_config(arch)), **kw)
    tcfg = _port_config(jcfg, arch)
    tree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(1))))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_value, atol=ATOL, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_value, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "musicgen-medium"])
@pytest.mark.parametrize("packed", [False, True])
def test_prefix_forward_matches_jax(arch, packed):
    """Logits and values (prefix rows stripped), and the fused stats, with
    and without a packed batch's segment ids."""
    jcfg, tcfg, jp, tp = _pair(arch)
    B, S, P = 2, 24, jcfg.n_prefix_tokens
    assert P == 8 and "mm_proj" in tp
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    pre = rng.standard_normal((B, P, jcfg.d_model)).astype(np.float32)
    kw, tkw = {}, {}
    if packed:
        seg = np.repeat(np.array([[1, 2]]), S // 2, axis=1).repeat(B, 0)
        kw["segment_ids"] = jnp.asarray(seg, jnp.int32)
        tkw["segment_ids"] = _t(seg).long()
    jout = JM.forward(jp, jnp.asarray(toks), jnp.asarray(pos), jcfg,
                      prefix_embeds=jnp.asarray(pre), **kw)
    out = M.forward(tp, _t(toks).long(), _t(pos).long(), tcfg,
                    prefix_embeds=_t(pre), **tkw)
    assert tuple(out["logits"].shape) == (B, S, jcfg.vocab_size)
    _close(out["logits"], jout["logits"])
    _close(out["values"], jout["values"])
    # the fused loss on the same rows
    tgt = np.concatenate([toks[:, 1:], toks[:, -1:]], axis=1)
    jf = JM.forward(jp, jnp.asarray(toks), jnp.asarray(pos),
                    dataclasses.replace(jcfg, fused_loss=True),
                    prefix_embeds=jnp.asarray(pre),
                    loss_targets=jnp.asarray(tgt), **kw)
    tf = M.forward(tp, _t(toks).long(), _t(pos).long(),
                   dataclasses.replace(tcfg, fused_loss=True),
                   prefix_embeds=_t(pre), loss_targets=_t(tgt).long(), **tkw)
    for k in ("token_logprobs", "lse", "entropy"):
        assert tuple(tf[k].shape) == (B, S)
        _close(tf[k], jf[k], msg=k)


def test_trainer_passes_the_prefix_through():
    """One Trainer step whose batch carries `prefix_embeds`, against the JAX
    Trainer's: metrics within 1e-5, params within 1e-6 but for at most 0.1%
    of a leaf's elements (at least one), all within 5e-5; the projector
    trains."""
    jcfg, tcfg, jp, tp = _pair("phi-3-vision-4.2b", fused_loss=True)
    rng = np.random.default_rng(9)
    rollouts = []
    for _ in range(4):
        L, pl = int(rng.integers(10, 30)), 3
        lp = np.where(np.arange(L) >= pl, -rng.random(L) * 3, 0)
        rollouts.append(Rollout(
            tokens=rng.integers(0, jcfg.vocab_size, L).astype(np.int32),
            prompt_len=pl, behavior_logprobs=lp.astype(np.float32),
            reward=float(rng.integers(0, 2)),
            weight_versions=np.zeros(L, np.int32), truncated=False))
    batch = pack(rollouts, batch=2, seq=64)
    # one prefix per row: without segment ids every token attends to it
    # (a packed batch puts the prefix in segment 0, which no token sees)
    del batch["segment_ids"]
    batch["prefix_embeds"] = rng.standard_normal(
        (2, jcfg.n_prefix_tokens, jcfg.d_model)).astype(np.float32)
    jtr = JaxTrainer(jcfg, jp, adam=JaxAdamConfig(lr=1e-3))
    ttr = Trainer(tcfg, tp, adam=AdamConfig(lr=1e-3), device="cpu")
    jm = dict(jtr.step(dict(batch)))
    tm = dict(ttr.step(dict(batch)))
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    assert not torch.equal(ttr.params["mm_proj"], tp["mm_proj"])
    for a, b in zip(tree_flatten(ttr.params)[0], jax.tree.leaves(jtr.params)):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert (np.abs(a - b) > 1e-6).sum() <= max(1, 1e-3 * a.size)
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)
