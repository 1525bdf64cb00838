"""The Mamba2 (SSM) path of the port through the engine, the Preprocessor,
the Trainer and PipelineRL, against the JAX package's, on the CPU.

Config: `smoke_config(get_config("mamba2-2.7b"))` (2 layers, d 256, 16
SSM heads of 32, state 16, chunk 16, float32) with the math task's vocab,
and its twin on the port's side. Both packages start from the same
converted weights and the same prompts. At temperature 1e-6 sampling is
greedy, so engines must produce identical tokens and version stamps (their
random draws differ: the port samples by Gumbel-max on a torch.Generator;
at the reference tests' 1e-4 this random-weight model has logit gaps of
2e-4 that the two packages' draws break differently); behavior logprobs
and SSM state agree within atol 1e-5 in float32. Trainer tolerances are
those of `test_torch_trainer.py`, the loop's those of
`test_torch_pipeline.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.core.pipeline import PipelineRL as JaxPipelineRL
from repro.core.preprocess import PreprocessConfig as JaxPreprocessConfig
from repro.core.preprocess import Preprocessor as JaxPreprocessor
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.core.rollout import GenerationEngine as JaxEngine
from repro.core.trainer import Trainer as JaxTrainer
from repro.data.math_task import MathTask as JaxTask
from repro.data.math_task import Problem as JaxProblem
from repro.data.packing import Rollout as JaxRollout
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro.sharding import tree_values
from repro_torch import (AdamConfig, EngineConfig, GenerationEngine,
                         PipelineConfig, PipelineRL, PreprocessConfig,
                         Preprocessor, Trainer, get_config)
from repro_torch.convert import (engine_state_from_numpy,
                                 engine_state_to_numpy, params_from_numpy)
from repro_torch.core import rollout as R
from repro_torch.core.weights import tree_flatten
from repro_torch.data.math_task import MathTask, Problem
from repro_torch.data.packing import Rollout, pack
from repro_torch.models import model as M

JTASK, TASK = JaxTask(max_operand=5, ops="+"), MathTask(max_operand=5, ops="+")
VOCAB = TASK.tok.vocab_size
ATOL = 1e-5
CPU = {"device": "cpu"}


def _configs(**kw):
    jcfg = dataclasses.replace(smoke_config(jax_get_config("mamba2-2.7b")),
                               vocab_size=VOCAB, **kw)
    tcfg = dataclasses.replace(
        get_config("mamba2-2.7b"), n_layers=2, d_model=256, vocab_size=VOCAB,
        ssm_head_dim=32, ssm_state=16, ssm_chunk=16, dtype=torch.float32,
        **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    tree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(seed))))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, **CPU))


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    ids = [[1] + rng.integers(3, VOCAB, n - 1).tolist() for n in lengths]
    return ([JaxProblem(list(p), 0) for p in ids],
            [Problem(list(p), 0) for p in ids])


def _source(problems):
    it = iter(list(problems))
    return lambda: next(it, None)


def _drain(eng, task, max_steps=300):
    out = []
    for _ in range(max_steps):
        eng.refill()
        out += eng.step(task)
        if eng.n_active == 0:
            break
    return out


def _same_rollouts(a_out, b_out, atol=ATOL):
    assert len(a_out) == len(b_out) > 0
    for a, b in zip(a_out, b_out):
        assert a.slot == b.slot and a.prompt_len == b.prompt_len
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.weight_versions, a.weight_versions)
        np.testing.assert_allclose(b.behavior_logprobs, a.behavior_logprobs,
                                   atol=atol, rtol=0)


LENGTHS = [5, 11, 7, 14, 9, 6]


@pytest.mark.parametrize("chunk", [4, 0])
def test_greedy_engine_matches_jax(chunk):
    """Chunked (4-token chunks) and legacy (token by token) admission: the
    SSM state after the first refill and every rollout of a full drain."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jprobs, tprobs = _prompts(LENGTHS)
    ec = dict(n_slots=3, max_len=24, prefill_chunk=chunk, temperature=1e-6)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ec), _source(jprobs), seed=1)
    teng = GenerationEngine(tcfg, tp, EngineConfig(**ec), _source(tprobs),
                            seed=1, **CPU)
    assert teng._cache_len is None and teng.prefill_chunk_size == chunk
    assert jeng.refill() == teng.refill() == 3
    assert teng.prefill_invocations == jeng.prefill_invocations
    for k in ("conv", "ssd"):
        np.testing.assert_allclose(teng.state["cache"][k].numpy(),
                                   np.asarray(jeng.state["cache"][k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    jout, tout = [], []
    for _ in range(300):
        assert jeng.refill() == teng.refill()
        jout += jeng.step(JTASK)
        tout += teng.step(TASK)
        if jeng.n_active == 0 and teng.n_active == 0:
            break
    _same_rollouts(jout, tout)
    assert len(tout) == len(LENGTHS)
    assert teng.tokens_generated == jeng.tokens_generated


def test_chunked_and_legacy_admission_agree():
    """The port's own law: chunked prefill lands a prompt in the state the
    token-at-a-time loop reaches, so greedy completions are identical
    (compared by prompt: the legacy loop spends the prompt's steps in the
    slot, so rollouts finish in another order)."""
    _, tcfg = _configs()
    _, tp = _params(*_configs())
    outs = []
    for chunk in (4, 0):
        _, probs = _prompts(LENGTHS, seed=2)
        eng = GenerationEngine(tcfg, tp, EngineConfig(
            n_slots=3, max_len=24, prefill_chunk=chunk, temperature=1e-6),
            _source(probs), seed=3, **CPU)
        outs.append({tuple(r.tokens[:r.prompt_len]): r
                     for r in _drain(eng, TASK)})
    assert set(outs[0]) == set(outs[1]) and len(outs[0]) == len(LENGTHS)
    for key, a in outs[0].items():
        b = outs[1][key]
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.behavior_logprobs, a.behavior_logprobs,
                                   atol=ATOL, rtol=0)


def test_ssm_state_after_chunked_refill_matches_fresh_prefill():
    """Twin of test_prefill.py's: after a drain, refilled slots hold
    exactly the state of a fresh prefill of their new prompts (no leak of
    the retired sequences' state)."""
    _, tcfg = _configs()
    _, tp = _params(*_configs())
    probs = [TASK.sample() for _ in range(4)]
    ec = EngineConfig(n_slots=2, max_len=12, prefill_chunk=4,
                      temperature=1e-4)
    eng = GenerationEngine(tcfg, tp, ec, _source(probs), seed=6, **CPU)
    eng.refill()
    for _ in range(100):
        eng.step(TASK)
        if eng.n_active == 0:
            break
    assert eng.refill() == 2
    fresh = GenerationEngine(tcfg, tp, ec, _source(probs[2:]), seed=6, **CPU)
    fresh.refill()
    for k in ("conv", "ssd"):
        np.testing.assert_allclose(eng.state["cache"][k].numpy(),
                                   fresh.state["cache"][k].numpy(),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_paged_setting_runs_the_slot_state_machine():
    """An attention-free config has nothing to page, in both packages: the
    engine keeps its slot state, admission costs 0 pages, and its rollouts
    equal the slot engine's bit for bit."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    ec = dict(n_slots=3, max_len=24, prefill_chunk=4, temperature=1e-4)
    outs = []
    for cache in ("slots", "paged"):
        _, probs = _prompts(LENGTHS, seed=4)
        eng = GenerationEngine(tcfg, tp, EngineConfig(**ec, cache=cache,
                                                      page_size=4),
                               _source(probs), seed=5, **CPU)
        assert not eng._paged and eng.tables is None
        assert set(eng.state["cache"]) == {"conv", "ssd"}
        assert eng.pages_needed(20) == 0 and eng.can_admit(20)
        assert eng.refill() == 3 and eng.last_admit_pages == 0
        outs.append(_drain(eng, TASK))
        eng.reset_slots()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.behavior_logprobs,
                                      b.behavior_logprobs)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ec, cache="paged",
                                               page_size=4),
                     _source(_prompts(LENGTHS, seed=4)[0]), seed=5)
    assert not jeng._paged and jeng.refill() == 3
    assert jeng.last_admit_pages == 0


def test_recompute_kv_leaves_the_state_unchanged(monkeypatch):
    """Recurrent state is not recomputed (nor in the JAX package), so an
    attention-free engine's `recompute_kv` update runs no forward and
    leaves the cache as it was, bit for bit."""
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg, tcfg)
    _, tp2 = _params(jcfg, tcfg, seed=1)
    _, probs = _prompts(LENGTHS[:3])
    eng = GenerationEngine(tcfg, tp, EngineConfig(
        n_slots=3, max_len=24, prefill_chunk=4, temperature=1e-4),
        _source(probs), seed=1, **CPU)
    eng.refill()
    for _ in range(3):
        eng.step(TASK)
    before = {k: v.clone() for k, v in eng.state["cache"].items()}

    def no_forward(*a, **k):
        raise AssertionError("recompute_kv ran a forward")

    monkeypatch.setattr(R.M, "forward", no_forward)
    eng.set_weights(tp2, version=1, recompute_kv=True)
    assert eng.version == 1 and eng.params is tp2
    for k, v in eng.state["cache"].items():
        assert torch.equal(v, before[k]), k


def test_engines_continue_from_one_converted_state():
    """The converter carries the JAX engine's state mid-rollout, its conv
    and SSD leaves included, into the port's engine and back; both then
    decode the same tokens."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jprobs, tprobs = _prompts(LENGTHS[:3], seed=6)
    ec = dict(n_slots=3, max_len=24, prefill_chunk=4, temperature=1e-6)
    ej = JaxEngine(jcfg, jp, JaxEngineConfig(**ec), _source(jprobs), seed=5)
    et = GenerationEngine(tcfg, tp, EngineConfig(**ec), _source([]),
                          seed=5, **CPU)
    ej.refill()
    for _ in range(3):
        ej.step(JTASK)
    state = {"state": {k: np.asarray(ej.state[k]) for k in
                       ("tokens", "lp", "n_cached", "prompt_len", "active")},
             "host": {k: np.array(getattr(ej, k)) for k in
                      ("_host_active", "_host_ncached", "_host_prompt_len",
                       "ver_buf")}}
    state["state"]["cache"] = {k: np.asarray(v)
                               for k, v in ej.state["cache"].items()}
    engine_state_from_numpy(et, state)
    et.problems = list(tprobs)
    back = engine_state_to_numpy(et)
    assert set(back["state"]["cache"]) == {"conv", "ssd"}
    for k in ("conv", "ssd"):
        np.testing.assert_array_equal(back["state"]["cache"][k],
                                      state["state"]["cache"][k])
    out_j, out_t = [], []
    for _ in range(40):
        out_j += ej.step(JTASK)
        out_t += et.step(TASK)
        if ej.n_active == 0 and et.n_active == 0:
            break
    _same_rollouts(sorted(out_j, key=lambda r: r.slot),
                   sorted(out_t, key=lambda r: r.slot))


# ---------------------------------------------------------------------------
# the Preprocessor and the Trainer
# ---------------------------------------------------------------------------

def _rollouts(n, seed=0, max_len=40):
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(n):
        L = int(rng.integers(8, max_len))
        pl = int(rng.integers(2, 6))
        lp = np.where(np.arange(L) >= pl, -rng.random(L) * 3, 0)
        fields.append(dict(
            tokens=rng.integers(0, VOCAB, L).astype(np.int32), prompt_len=pl,
            behavior_logprobs=lp.astype(np.float32),
            reward=float(rng.integers(0, 2)),
            weight_versions=np.zeros(L, np.int32), truncated=False))
    return ([JaxRollout(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                           for k, v in f.items()}) for f in fields],
            [Rollout(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                        for k, v in f.items()}) for f in fields])


def test_preprocessor_matches_jax():
    """Fused loss; the bucket (32) is a multiple of the chunk, so every
    layer takes the scan kernel's path (its plain version here) against
    the Pallas kernel in interpret mode."""
    jcfg, tcfg = _configs(fused_loss=True)
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    jp, tp = _params(jcfg, tcfg)
    jr, tr = _rollouts(4, seed=2, max_len=30)
    JaxPreprocessor(jcfg, jp, JaxPreprocessConfig(
        kl_coef=0.05, max_len=32)).process(jr)
    Preprocessor(tcfg, tp, PreprocessConfig(kl_coef=0.05, max_len=32),
                 **CPU).process(tr)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.ref_logprobs, b.ref_logprobs,
                                   atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(a.token_rewards, b.token_rewards,
                                   atol=2e-5, rtol=0)


def test_trainer_step_matches_jax():
    """One step on a packed batch with the fused loss and remat. The JAX
    Trainer differentiates `ssd_chunked` (it cannot differentiate the
    Pallas scan); the port's Trainer takes the same path. Metrics within
    1e-5; params within 1e-6 but for at most 0.1% of the elements, which
    stay within 5e-5 (`test_torch_trainer.py`)."""
    jcfg, tcfg = _configs(fused_loss=True, remat=True)
    jp, tp = _params(jcfg, tcfg)
    jtr = JaxTrainer(jcfg, jp, adam=JaxAdamConfig(lr=1e-3))
    ttr = Trainer(tcfg, tp, adam=AdamConfig(lr=1e-3), **CPU)
    batch = pack(_rollouts(6, seed=7)[1], batch=2, seq=64)
    jm = dict(jtr.step(dict(batch)))
    tm = dict(ttr.step(dict(batch)))
    assert set(jm) == set(tm) and ttr.version == jtr.version == 1
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    assert tm["grad_norm"] > 0
    for a, b in zip(tree_flatten(ttr.params)[0], jax.tree.leaves(jtr.params)):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert (np.abs(a - b) > 1e-6).mean() <= 1e-3
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)


def test_jax_checkpoint_of_the_ssm_tree_restores_into_the_port(tmp_path):
    """The JAX Trainer's checkpoint of the SSM tree (params and Adam
    moments) restores into the port's Trainer exactly, and the port's own
    save writes the same keys."""
    jcfg, tcfg = _configs(fused_loss=True)
    jp, tp = _params(jcfg, tcfg)
    jtr = JaxTrainer(jcfg, jp, adam=JaxAdamConfig(lr=1e-3))
    jtr.step(pack(_rollouts(6, seed=8)[1], batch=2, seq=64))
    path = jtr.save(str(tmp_path / "jax"))
    ttr = Trainer(tcfg, tp, adam=AdamConfig(lr=1e-3), **CPU)
    assert ttr.restore(path) == 1
    for a, b in zip(tree_flatten(ttr.params)[0], jax.tree.leaves(jtr.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mine = ttr.save(str(tmp_path / "port"))
    with np.load(path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any("ssm" in f for f in a.files)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _trace(loop):
    """Record every event's firing time on `loop`."""
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
    and prompts at temperature 1e-4, streamed broadcast: the same event
    schedule, versions, lags, token counts and rewards; losses within 1e-4
    relative."""
    jtask, task = JaxTask(max_operand=3, ops="+"), MathTask(max_operand=3,
                                                           ops="+")
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    ec = dict(n_slots=8, max_len=16, temperature=1e-4, prefill_chunk=4)
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
    jb, tb = J.broadcast_stats(), T.broadcast_stats()
    for k in ("updates_applied", "streams_completed", "pause_total"):
        assert tb["engines"][0][k] == jb["engines"][0][k], k
    assert T.lag_stats()["histogram"] == J.lag_stats()["histogram"]
