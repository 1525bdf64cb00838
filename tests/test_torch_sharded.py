"""The port's vocab-parallel fused loss and expert-parallel MoE over two
gloo ranks on the CPU, held against the JAX package's unsharded functions.

One spawn per file (`tests/torch_sharded_worker.py`, two ranks on a
("model",) mesh of 2) runs every case; the JAX oracles run here:

- `fused_logprob_sharded`: value and gradients to hidden and head through
  all three outputs, tied and untied, against `fused_logprob_blocked` at
  2e-4 (the JAX package's `test_mesh_runtime.py` tolerance);
- the model's fused loss under `sharding_context` (every parameter placed
  by the rules: tensor parallel over "model") for smoke llama3-8b and
  granite-moe, tied and untied: the per-token stats at 2e-4 and every
  parameter's gradient at 5e-4, as the JAX package's own sharded test;
- `moe_apply` expert-parallel against the JAX unsharded `moe_apply` at
  1e-5, dropping (capacity factor 0.25) and not; its gradients against
  the unsharded port's, and every rank's routing decisions against the
  unsharded routing;
- `execute_weight_update` timing three chunks of a smoke config.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke
from repro.kernels.fused_logprob import fused_logprob_blocked
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.sharding import tree_values

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(3)
MODEL_CASES = [(a, t) for a in ("llama3-8b", "granite-moe-1b-a400m")
               for t in (False, True)]
CAPACITY = (0.25, 2.0)


def _jax_model_cfg(arch, tied):
    return dataclasses.replace(jax_smoke(jax_get_config(arch)),
                               tie_embeddings=tied, use_mtp=False,
                               fused_loss=True)


def _moe_cfg(cf):
    return dataclasses.replace(jax_smoke(jax_get_config(
        "granite-moe-1b-a400m")), capacity_factor=cf)


def _moe_weights(cfg, seed):
    """Unit-scale router, so routing is decided by the data."""
    rng = np.random.default_rng(seed)
    d, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = {"router": rng.standard_normal((d, E)) * d ** -0.5,
         "gate": rng.standard_normal((E, d, Fd)) * d ** -0.5,
         "up": rng.standard_normal((E, d, Fd)) * d ** -0.5,
         "down": rng.standard_normal((E, Fd, d)) * Fd ** -0.5}
    return {k: v.astype(np.float32) for k, v in w.items()}


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    N, D, V = 48, 32, 64
    loss = {}
    for tied in (False, True):
        loss[tied] = {
            "h": rng.standard_normal((N, D)).astype(np.float32),
            "w": (rng.standard_normal((V, D) if tied else (D, V)) * 0.3
                  ).astype(np.float32),
            "t": rng.integers(0, V, N).astype(np.int64)}
    model = {}
    for arch, tied in MODEL_CASES:
        cfg = _jax_model_cfg(arch, tied)
        B, S = 2, 16
        model[(arch, tied)] = {
            "tree": jax.tree.map(np.asarray, tree_values(
                JM.init_params(cfg, KEY))),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64),
            "positions": np.broadcast_to(np.arange(S)[None], (B, S)).copy(),
            "overrides": {"use_mtp": False}}
    moe = {}
    for cf in CAPACITY:
        cfg = _moe_cfg(cf)
        moe[cf] = {"w": _moe_weights(cfg, 7),
                   "x": rng.standard_normal((4, 16, cfg.d_model)
                                            ).astype(np.float32),
                   "r": rng.standard_normal((4, 16, cfg.d_model)
                                            ).astype(np.float32),
                   "overrides": {}}
    return {"loss": loss, "model": model, "moe": moe}


@functools.lru_cache(maxsize=None)
def _ranks():
    """Both ranks' results of one spawn."""
    tmp = tempfile.mkdtemp(prefix="sharded_")
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_sharded_worker.py"),
         path, tmp], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


def _scalar(lp, lse, ent):
    return (lp * 1.3 - 0.7 * lse + 0.11 * ent).sum()


@pytest.mark.parametrize("tied", [False, True])
def test_sharded_fused_logprob_value_and_grads(tied):
    c = _inputs()["loss"][tied]
    h, w, t = (jnp.asarray(c[k]) for k in ("h", "w", "t"))
    v, (gh, gw) = jax.value_and_grad(
        lambda h, w: _scalar(*fused_logprob_blocked(h, w, t,
                                                    transpose_head=tied)),
        argnums=(0, 1))(h, w)
    stats = fused_logprob_blocked(h, w, t, transpose_head=tied)
    for r in _ranks():
        got = r["loss"][tied]
        # each rank holds half the vocab
        assert got["local_w"] == ((32, 32) if tied else (32, 32))
        np.testing.assert_allclose(got["value"], float(v), rtol=2e-4,
                                   atol=2e-4)
        for a, b in zip(got["stats"], stats):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4,
                                       atol=2e-4)
        np.testing.assert_allclose(got["dh"], np.asarray(gh), rtol=2e-4,
                                   atol=2e-4, err_msg="dhidden")
        np.testing.assert_allclose(got["dw"], np.asarray(gw), rtol=2e-4,
                                   atol=2e-4, err_msg="dhead")


@pytest.mark.parametrize("arch,tied", MODEL_CASES)
def test_sharded_fused_loss_through_model(arch, tied):
    c = _inputs()["model"][(arch, tied)]
    cfg = _jax_model_cfg(arch, tied)
    tokens = jnp.asarray(c["tokens"], jnp.int32)
    positions = jnp.asarray(c["positions"], jnp.int32)
    tgt = jnp.concatenate([tokens[:, 1:], tokens[:, -1:]], axis=1)

    def loss(p):
        out = JM.forward(p, tokens, positions, cfg, loss_targets=tgt)
        return _scalar(out["token_logprobs"], out["lse"],
                       out["entropy"]), out

    params = jax.tree.map(jnp.asarray, c["tree"])
    (v, out), g = jax.value_and_grad(loss, has_aux=True)(params)
    want = jax.tree_util.tree_leaves(g)
    for r in _ranks():
        got = r["model"][(arch, tied)]
        V = cfg.vocab_size
        assert V // 2 in got["head_local"]
        np.testing.assert_allclose(got["value"], float(v), rtol=2e-4,
                                   atol=2e-4)
        for a, k in zip(got["stats"], ("token_logprobs", "lse", "entropy")):
            np.testing.assert_allclose(a, np.asarray(out[k]), rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        assert len(got["grads"]) == len(want)
        for i, (a, b) in enumerate(zip(got["grads"], want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4,
                                       atol=5e-4, err_msg=f"leaf {i}")


@pytest.mark.parametrize("cf", CAPACITY)
def test_moe_expert_parallel_matches_jax(cf):
    c = _inputs()["moe"][cf]
    cfg = _moe_cfg(cf)
    jout, jaux = JMoE.moe_apply({k: jnp.asarray(v) for k, v in c["w"].items()},
                                jnp.asarray(c["x"]), cfg)
    T = c["x"].shape[0] * c["x"].shape[1]
    dropped = T * cfg.experts_per_token > cfg.n_experts * JMoE._capacity(T,
                                                                        cfg)
    assert dropped == (cf < 1)
    for r in _ranks():
        got = r["moe"][cf]
        assert got["capacity"] == JMoE._capacity(T, cfg)
        np.testing.assert_allclose(got["out"], np.asarray(jout), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["aux"], float(jaux), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("cf", CAPACITY)
def test_moe_expert_parallel_decisions_and_grads(cf):
    """Every rank's kept (token, expert, slot) choices are the unsharded
    routing's restricted to its experts, the two ranks' together are all
    of them, and the gradients equal the unsharded port's."""
    ranks = _ranks()
    kept = []
    for r in ranks:
        got = r["moe"][cf]
        C, off, nl = got["capacity"], got["offset"], got["n_local"]
        for d_ep, d_all in zip(got["dests_ep"], got["dests_all"]):
            ovf_all = d_all == 4 * C
            mine = (~ovf_all) & (d_all // C >= off) & (d_all // C < off + nl)
            np.testing.assert_array_equal(d_ep[mine], d_all[mine] - off * C)
            assert (d_ep[~mine] == nl * C).all()
        kept.append(sum(int((d != nl * C).sum()) for d in got["dests_ep"]))
        np.testing.assert_allclose(got["out"], got["out_single"], atol=1e-5,
                                   rtol=0)
        # gradients: the shards' partial sums reassociate float32 adds
        np.testing.assert_allclose(got["dx"], got["dx_single"], atol=1e-5,
                                   rtol=1e-5)
        for k in got["grads"]:
            np.testing.assert_allclose(got["grads"][k],
                                       got["grads_single"][k], atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    all_kept = sum(int((d != 4 * ranks[0]["moe"][cf]["capacity"]).sum())
                   for d in ranks[0]["moe"][cf]["dests_all"])
    assert sum(kept) == all_kept


def test_execute_weight_update_times_three_chunks():
    for r in _ranks():
        rec = r["weight_update"]
        assert [c["chunk"] for c in rec] == [0, 1, 2]
        assert all(c["nbytes"] > 0 and c["t_exec_s"] > 0 for c in rec)
