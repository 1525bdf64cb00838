"""The MoE path of the port against the JAX package's, on the CPU: the
routed layer (`models/moe.py`), the model's `aux_loss`, the engine, the
Trainer's `moe_aux` and PipelineRL.

Config: `smoke_config(get_config("granite-moe-1b-a400m"))` (2 layers, d
256, 4/4 heads of 32, 4 experts top 2, expert d_ff 64, float32) with the
math task's vocab, and the port's config with the same fields. Both
packages start from the same converted weights and get the same numpy
inputs.

Routing is held decision for decision: a token past its expert's capacity
is dropped, so one changed choice would move an output by the order of the
output, not by a rounding. Tolerances, float32: the layer, the aux loss and
the model's logits and values within atol 1e-5; engines at temperature 1e-6
(greedy) in the same admission mode give equal tokens and stamps and
behavior logprobs within 1e-5 (the capacity is shared by every row of a
call, inactive slots and unadmitted rows included, in both packages, so
each engine is held to the JAX engine in its own admission mode and not
chunked to legacy: ROADMAP.md C.9); Trainer and PipelineRL those of
`test_torch_ssm_engine.py`, the aux loss within 1e-6.
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
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.core.pipeline import PipelineRL as JaxPipelineRL
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.core.rollout import GenerationEngine as JaxEngine
from repro.core.trainer import Trainer as JaxTrainer
from repro.data.math_task import MathTask as JaxTask
from repro.data.math_task import Problem as JaxProblem
from repro.models import moe as JMoE
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro.sharding import tree_values
from repro_torch import (AdamConfig, EngineConfig, GenerationEngine,
                         PipelineConfig, PipelineRL, Trainer, get_config)
from repro_torch.convert import params_from_numpy
from repro_torch.core.weights import tree_flatten
from repro_torch.data.math_task import MathTask, Problem
from repro_torch.data.packing import Rollout, pack
from repro_torch.models import model as M
from repro_torch.models import moe as TMoE

JTASK, TASK = JaxTask(max_operand=5, ops="+"), MathTask(max_operand=5, ops="+")
VOCAB = TASK.tok.vocab_size
ATOL = 1e-5
CPU = {"device": "cpu"}


def _configs(**kw):
    jcfg = dataclasses.replace(
        smoke_config(jax_get_config("granite-moe-1b-a400m")),
        vocab_size=VOCAB, **kw)
    tcfg = get_config("granite-moe-1b-a400m")
    same = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcfg)
            if f.name != "dtype"}
    return jcfg, dataclasses.replace(tcfg, dtype=torch.float32, **same)


@functools.lru_cache(maxsize=None)
def _numpy_tree(jcfg, seed):
    return jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(seed))))


def _params(jcfg, tcfg, seed=0):
    """The same random weights in both packages. The JAX tree is drawn once
    per parameter layout (the options that change no leaf share it)."""
    base = dataclasses.replace(
        _configs()[0], n_dense_layers=jcfg.n_dense_layers,
        dense_d_ff=jcfg.dense_d_ff, n_shared_experts=jcfg.n_shared_experts)
    tree = _numpy_tree(base, seed)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, **CPU))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_value, atol=ATOL, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_value, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


# ---------------------------------------------------------------------------
# the routed layer
# ---------------------------------------------------------------------------

def _layer_weights(cfg, seed):
    """One layer's MoE weights at the config's shapes, unit-scale router
    (probabilities far from uniform, so routing is decided by the data)."""
    rng = np.random.default_rng(seed)
    d, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = {"router": rng.standard_normal((d, E)) * d ** -0.5,
         "gate": rng.standard_normal((E, d, Fd)) * d ** -0.5,
         "up": rng.standard_normal((E, d, Fd)) * d ** -0.5,
         "down": rng.standard_normal((E, Fd, d)) * Fd ** -0.5}
    if cfg.n_shared_experts:
        SF = Fd * cfg.n_shared_experts
        w.update(shared_gate=rng.standard_normal((d, SF)) * d ** -0.5,
                 shared_up=rng.standard_normal((d, SF)) * d ** -0.5,
                 shared_down=rng.standard_normal((SF, d)) * SF ** -0.5)
    return {k: v.astype(np.float32) for k, v in w.items()}


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("capacity_factor", [0.25, 2.0])
def test_moe_apply_matches_jax(shared, capacity_factor):
    """`moe_apply` (with and without shared experts) against the JAX
    package's single-device `_moe_local` path: the output and the aux loss.
    At capacity factor 0.25 the 64 tokens' 128 expert choices meet 4
    experts of capacity 8, so most are dropped."""
    jcfg, tcfg = _configs(n_shared_experts=shared,
                          capacity_factor=capacity_factor)
    w = _layer_weights(tcfg, seed=3 + shared)
    x = np.random.default_rng(4).standard_normal((4, 16, tcfg.d_model)
                                                 ).astype(np.float32)
    T = x.shape[0] * x.shape[1]
    C = TMoE._capacity(T, tcfg)
    assert C == JMoE._capacity(T, jcfg)
    dropped = T * tcfg.experts_per_token > tcfg.n_experts * C
    assert dropped == (capacity_factor < 1)
    jout, jaux = JMoE.moe_apply({k: jnp.asarray(v) for k, v in w.items()},
                                jnp.asarray(x), jcfg)
    out, aux = TMoE.moe_apply({k: _t(v) for k, v in w.items()}, _t(x), tcfg)
    assert out.shape == x.shape and aux.dtype == torch.float32
    _close(out, jout)
    _close(aux, jaux)
    if dropped:
        # the dropped choices change the output by the order of the output
        full, _ = TMoE.moe_apply({k: _t(v) for k, v in w.items()}, _t(x),
                                 dataclasses.replace(tcfg,
                                                     capacity_factor=2.0))
        assert float((full - out).abs().max()) > 0.1


@pytest.mark.parametrize("dense_layers", [0, 1])
def test_forward_aux_loss_matches_jax(dense_layers):
    """The model forward: logits, values and the summed aux loss of the MoE
    layers; a cache-returning forward gives the same aux loss. With one
    leading dense layer of its own d_ff (DeepSeek's layout, no ported
    config has it yet) the tree has two groups, converted leaf for leaf
    and walked in order."""
    jcfg, tcfg = _configs(n_dense_layers=dense_layers,
                          dense_d_ff=128 if dense_layers else 0)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, (2, 24)).astype(np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    groups = [("dense", 1), ("moe", 1)] if dense_layers else [("moe", 2)]
    assert M.layer_groups(tcfg) == JM.layer_groups(jcfg) == groups
    assert len(tp["groups"]) == len(groups)
    if dense_layers:
        assert tuple(tp["groups"][0]["ffn"]["up"].shape) == (1, 256, 128)
    jout = JM.forward(jp, jnp.asarray(toks), jnp.asarray(pos), jcfg)
    out = M.forward(tp, _t(toks).long(), _t(pos).long(), tcfg)
    _close(out["logits"], jout["logits"])
    _close(out["values"], jout["values"])
    _close(out["aux_loss"], jout["aux_loss"])
    assert float(out["aux_loss"]) > 0
    again = M.forward(tp, _t(toks).long(), _t(pos).long(), tcfg,
                      return_cache=True)
    assert float(again["aux_loss"]) == float(out["aux_loss"])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    ids = [[1] + rng.integers(3, VOCAB, n - 1).tolist() for n in lengths]
    return ([JaxProblem(list(p), 0) for p in ids],
            [Problem(list(p), 0) for p in ids])


def _source(problems):
    it = iter(list(problems))
    return lambda: next(it, None)


LENGTHS = [5, 11, 7, 14, 9, 6]


@pytest.mark.parametrize("chunk,capacity_factor",
                         [(4, 2.0), (0, 2.0), (8, 0.5)])
def test_greedy_engine_matches_jax(chunk, capacity_factor):
    """Chunked (4-token chunks) and legacy admission, each against the JAX
    engine in the same mode. At capacity factor 0.5 with 8-token chunks
    every prefill chunk drops choices (3 rows x 8 tokens make 48 choices
    for 4 experts of capacity 8), and the two packages drop the same
    ones."""
    jcfg, tcfg = _configs(capacity_factor=capacity_factor)
    if capacity_factor < 1:
        assert 3 * chunk * 2 > 4 * TMoE._capacity(3 * chunk, tcfg)
    jp, tp = _params(jcfg, tcfg)
    jprobs, tprobs = _prompts(LENGTHS)
    ec = dict(n_slots=3, max_len=24, prefill_chunk=chunk, temperature=1e-6)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ec), _source(jprobs), seed=1)
    teng = GenerationEngine(tcfg, tp, EngineConfig(**ec), _source(tprobs),
                            seed=1, **CPU)
    jout, tout = [], []
    for _ in range(300):
        assert jeng.refill() == teng.refill()
        if jeng.n_active == 0 and teng.n_active == 0:
            break
        jout += jeng.step(JTASK)
        tout += teng.step(TASK)
    assert len(tout) == len(jout) == len(LENGTHS)
    for a, b in zip(jout, tout):
        assert a.slot == b.slot and a.prompt_len == b.prompt_len
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.weight_versions, a.weight_versions)
        np.testing.assert_allclose(b.behavior_logprobs, a.behavior_logprobs,
                                   atol=ATOL, rtol=0)
    assert teng.tokens_generated == jeng.tokens_generated
    assert teng.prefill_invocations == jeng.prefill_invocations


# ---------------------------------------------------------------------------
# the Trainer and the loop
# ---------------------------------------------------------------------------

def _rollouts(n, seed=0, max_len=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(8, max_len))
        pl = int(rng.integers(2, 6))
        lp = np.where(np.arange(L) >= pl, -rng.random(L) * 3, 0)
        out.append(Rollout(
            tokens=rng.integers(0, VOCAB, L).astype(np.int32), prompt_len=pl,
            behavior_logprobs=lp.astype(np.float32),
            reward=float(rng.integers(0, 2)),
            weight_versions=np.zeros(L, np.int32), truncated=False))
    return out


def test_trainer_step_with_moe_aux_matches_jax():
    """One step on a packed batch with the fused loss and remat: the loss
    carries rl.aux_coef x aux_loss, `moe_aux` is reported, and the router
    (float32) and experts train. Metrics within 1e-5 (moe_aux within
    1e-6); params within 1e-6 but for at most 0.1% of a leaf's elements
    (at least one), all within 5e-5."""
    jcfg, tcfg = _configs(fused_loss=True, remat=True)
    jp, tp = _params(jcfg, tcfg)
    jtr = JaxTrainer(jcfg, jp, adam=JaxAdamConfig(lr=1e-3))
    ttr = Trainer(tcfg, tp, adam=AdamConfig(lr=1e-3), **CPU)
    batch = pack(_rollouts(6, seed=7), batch=2, seq=64)
    jm = dict(jtr.step(dict(batch)))
    tm = dict(ttr.step(dict(batch)))
    assert set(jm) == set(tm) and "moe_aux" in tm
    assert ttr.version == jtr.version == 1
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=0,
                                   atol=1e-6 if k == "moe_aux" else 1e-5,
                                   err_msg=k)
    assert np.isfinite(tm["moe_aux"]) and tm["moe_aux"] > 0
    router = ttr.params["groups"][0]["moe"]["router"]
    assert router.dtype == torch.float32
    assert not torch.equal(router, tp["groups"][0]["moe"]["router"])
    for a, b in zip(tree_flatten(ttr.params)[0], jax.tree.leaves(jtr.params)):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert (np.abs(a - b) > 1e-6).sum() <= max(1, 1e-3 * a.size)
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)


def _trace(loop):
    fired, raw = [], loop.step

    def step():
        ok = raw()
        if ok:
            fired.append(loop.now)
        return ok

    loop.step = step
    return fired


def test_pipeline_matches_jax_pipeline():
    """3 optimizer steps of both packages' PipelineRL from the same weights
    and prompts at temperature 1e-6, chunked admission, streamed
    broadcast: the same event schedule, versions, lags, token counts and
    rewards; losses within 1e-4 relative."""
    jtask, task = JaxTask(max_operand=3, ops="+"), MathTask(max_operand=3,
                                                           ops="+")
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    ec = dict(n_slots=8, max_len=16, temperature=1e-6, prefill_chunk=4)
    pc = dict(batch_size=8, n_opt_steps=3, n_chips=8, train_chips=4,
              pack_rows=3, pack_seq=64, broadcast="streamed",
              broadcast_chunks=4)
    J = JaxPipelineRL(jcfg, jp, jtask, JaxEngineConfig(**ec),
                      JaxPipelineConfig(**pc), trainer=JaxTrainer(jcfg, jp))
    T = PipelineRL(tcfg, tp, task, EngineConfig(**ec), PipelineConfig(**pc),
                   trainer=Trainer(tcfg, tp, **CPU), **CPU)
    fj, ft = _trace(J.loop), _trace(T.loop)
    jlog, tlog = J.run(), T.run()
    assert ft == fj
    assert len(tlog) == len(jlog) == 3
    for a, b in zip(jlog, tlog):
        for k in ("version", "samples", "time", "reward", "max_lag",
                  "mean_lag", "mean_len", "fill", "queue_depth"):
            assert b[k] == a[k], k
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
    je, te = J.engine, T.engine
    for k in ("version", "tokens_generated", "prefill_tokens"):
        assert getattr(te, k) == getattr(je, k), k
    assert te.version >= 1
    hist = [dict(m) for m in T.trainer.history]
    assert len(hist) == 3 and all(np.isfinite(m["moe_aux"]) for m in hist)
