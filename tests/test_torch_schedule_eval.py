"""The port's LR schedules and periodic Evaluator on the CPU: twins of
`test_schedule_eval.py`, each held against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.evaluator import Evaluator as JaxEvaluator
from repro.core.trainer import Trainer as JaxTrainer
from repro.data.math_task import MathTask as JaxTask
from repro.optim import schedule as JS
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro_torch import AdamConfig, Evaluator, Trainer
from repro_torch.data.math_task import MathTask
from repro_torch.optim import schedule as TS
from torch_twin import CPU, one_thread, weights


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _at(fn, t):
    return float(fn(torch.tensor(t, dtype=torch.int32)))


def test_warmup_cosine_shape():
    s = TS.warmup_cosine(1.0, warmup_steps=10, total_steps=100)
    js = JS.warmup_cosine(1.0, warmup_steps=10, total_steps=100)
    assert _at(s, 0) == 0.0
    assert _at(s, 10) == pytest.approx(1.0)
    assert _at(s, 55) < 1.0
    assert _at(s, 100) == pytest.approx(0.1, abs=1e-6)
    vals = [_at(s, t) for t in range(10, 101, 10)]
    assert vals == sorted(vals, reverse=True)
    for t in range(0, 101, 5):
        assert _at(s, t) == pytest.approx(float(js(jnp.int32(t))), rel=1e-6)


def test_warmup_constant():
    s = TS.warmup_constant(2.0, warmup_steps=4)
    js = JS.warmup_constant(2.0, warmup_steps=4)
    assert _at(s, 2) == pytest.approx(1.0)
    assert _at(s, 8) == pytest.approx(2.0)
    for t in range(10):
        assert _at(s, t) == pytest.approx(float(js(jnp.int32(t))), rel=1e-6)


def test_trainer_with_schedule_reports_lr():
    jcfg, cfg, jp, params = weights()
    tr = Trainer(cfg, params, adam=AdamConfig(lr=1e-3),
                 lr_schedule=TS.warmup_constant(1e-3, warmup_steps=5), **CPU)
    jtr = JaxTrainer(jcfg, jp, adam=JaxAdamConfig(lr=1e-3),
                     lr_schedule=JS.warmup_constant(1e-3, warmup_steps=5))
    rng = np.random.default_rng(1)
    B, S = 2, 32
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "positions": np.broadcast_to(np.arange(S, dtype=np.int32)[None],
                                     (B, S)).copy(),
        "segment_ids": np.ones((B, S), np.int32),
        "loss_mask": np.ones((B, S), np.float32),
        "behavior_logprobs": np.full((B, S), -1.0, np.float32),
        "rewards": np.full((B, S), 0.5, np.float32),
    }
    m1, m2 = tr.step(batch), tr.step(batch)
    j1 = jtr.step({k: jnp.asarray(v) for k, v in batch.items()})
    j2 = jtr.step({k: jnp.asarray(v) for k, v in batch.items()})
    assert m1["lr"] == pytest.approx(0.0)
    assert m2["lr"] == pytest.approx(2e-4)
    assert m2["lr"] == pytest.approx(j2["lr"], rel=1e-6)
    assert m2["loss"] == pytest.approx(j2["loss"], rel=1e-4)
    assert m1["loss"] == pytest.approx(j1["loss"], rel=1e-4)


def test_evaluator_runs_and_scores():
    """Same problems, same weights: the port's success rate, mean length
    and count equal the JAX Evaluator's, and repeat."""
    jcfg, cfg, jp, params = weights()
    ev = Evaluator(cfg, MathTask(max_operand=3, ops="+"), n_problems=8,
                   max_len=12, **CPU)
    jev = JaxEvaluator(jcfg, JaxTask(max_operand=3, ops="+"), n_problems=8,
                       max_len=12)
    assert [p.prompt_ids for p in ev.problems] == \
        [p.prompt_ids for p in jev.problems]
    m, jm = ev.evaluate(params), jev.evaluate(jp)
    assert m["n"] >= 8
    assert 0.0 <= m["success_rate"] <= 1.0
    assert m["mean_len"] > 0
    assert m == jm
    assert ev.evaluate(params) == m
