"""The port's PipelineRL and ConventionalRL on the CPU: twins of
`test_pipeline.py`, `test_group_baseline.py`,
`test_system.py::test_ess_stays_high_during_training` and the quickstart,
and the parity of the port's PipelineRL with the JAX package's.

Parity: both packages start from the same converted weights (tiny config,
2 layers, d 64, float32) and the same prompt stream, at temperature 1e-4
(greedy), for 3 optimizer steps. The event schedule (every event's firing
time), versions, lags, token counts and rewards must be equal; losses agree
within 1e-4 relative (float32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.tiny import config as jax_tiny
from repro.core.algo import RLConfig as JaxRLConfig
from repro.core.events import apply_group_baseline as jax_group_baseline
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.core.pipeline import PipelineRL as JaxPipelineRL
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.core.trainer import Trainer as JaxTrainer
from repro.data.math_task import MathTask as JaxTask
from repro.data.packing import Rollout as JaxRollout
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro.sharding import tree_values
from repro_torch import (AdamConfig, ConventionalConfig, ConventionalRL,
                         EngineConfig, PipelineConfig, PipelineRL, RLConfig,
                         Trainer)
from repro_torch.configs import tiny as port_tiny
from repro_torch.convert import params_from_numpy
from repro_torch.core.events import apply_group_baseline
from repro_torch.data.math_task import MathTask
from repro_torch.data.packing import Rollout
from repro_torch.models import model as M

CPU = {"device": "cpu"}
PC = dict(batch_size=4, n_chips=8, train_chips=4, pack_rows=2, pack_seq=48)


@pytest.fixture(scope="module")
def setup():
    task = MathTask(max_operand=5, ops="+")
    cfg = port_tiny.config(vocab_size=task.tok.vocab_size, d_model=64,
                           n_layers=1)
    return task, cfg, M.init_params(cfg, 0, **CPU)


def _run(setup, n_engines=1, **pc):
    task, cfg, params = setup
    p = PipelineRL(cfg, params, task, EngineConfig(n_slots=8, max_len=20),
                   PipelineConfig(**dict(PC, n_engines=n_engines, **pc)),
                   **CPU)
    return p, p.run()


@pytest.mark.parametrize("n_engines", [1, 2])
def test_pipeline_runs_and_logs(setup, n_engines):
    p, log = _run(setup, n_engines, n_opt_steps=4)
    assert len(log) == 4
    assert log[-1]["version"] == 4 and log[-1]["time"] > 0
    assert all("ess" in r for r in log)


@pytest.mark.parametrize("n_engines", [1, 2])
def test_pipeline_lag_bounded_and_mixed(setup, n_engines):
    """Fig. 3a: a stable, bounded max lag once warm, mixed-policy batches."""
    p, log = _run(setup, n_engines, n_opt_steps=8)
    warm = log[3:]
    assert 0 < max(r["max_lag"] for r in warm) <= 8
    assert all(r["mean_lag"] <= r["max_lag"] for r in warm)


def test_conventional_lag_grows_with_g(setup):
    """Alg. 1: within one RL step, batch g has lag exactly g."""
    task, cfg, params = setup
    c = ConventionalRL(cfg, params, task, EngineConfig(n_slots=8, max_len=20),
                       ConventionalConfig(batch_size=4, g_steps=3,
                                          n_opt_steps=6, n_chips=8,
                                          pack_rows=2, pack_seq=48), **CPU)
    for i, r in enumerate(c.run()):
        assert r["max_lag"] == i % 3
        assert r["mean_lag"] == pytest.approx(i % 3)


def test_pipeline_weight_updates_propagate(setup):
    p, _ = _run(setup, n_opt_steps=6)
    assert p.engine.version > 0


def test_sim_clock_monotonic(setup):
    _, log = _run(setup, n_opt_steps=5)
    times = [r["time"] for r in log]
    assert times == sorted(times)


# ---------------------------------------------------------------------------
# GRPO group baseline
# ---------------------------------------------------------------------------

def _mk(cls, reward, key):
    return cls(tokens=np.zeros(4, np.int32), prompt_len=1,
               behavior_logprobs=np.zeros(4, np.float32), reward=reward,
               weight_versions=np.zeros(4, np.int32), prompt_key=key)


def test_group_baseline_zero_mean_per_group():
    spec = [(1.0, 7), (0.0, 7), (0.5, 9), (0.5, 9), (0.25, 3)]
    rollouts = [_mk(Rollout, r, k) for r, k in spec]
    out = apply_group_baseline(rollouts)
    assert [r.reward for r in out] == pytest.approx([0.5, -0.5, 0, 0, 0])
    assert rollouts[0].reward == 1.0            # originals untouched
    assert [r.reward for r in out] == [r.reward for r in jax_group_baseline(
        [_mk(JaxRollout, r, k) for r, k in spec])]


class RepeatingSampler:
    """Yields each sampled problem `group` times (GRPO group sampling)."""

    def __init__(self, task, group=4):
        self.task, self.group = task, group
        self._left, self._cur = 0, None

    def __call__(self):
        if self._left == 0:
            self._cur = self.task.sample()
            self._left = self.group
        self._left -= 1
        return self._cur


@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_pipeline_runs_with_group_baseline(cache):
    """Paged engines fork each group's prompt copy-on-write."""
    task = MathTask(max_operand=3, ops="+")
    cfg = port_tiny.config(vocab_size=task.tok.vocab_size, d_model=64,
                           n_layers=1, use_value_head=False)
    params = M.init_params(cfg, 0, **CPU)
    p = PipelineRL(cfg, params, task,
                   EngineConfig(n_slots=8, max_len=16, cache=cache,
                                page_size=4, paged_attention="kernel"),
                   PipelineConfig(batch_size=8, n_opt_steps=3, n_chips=8,
                                  train_chips=4, pack_rows=3, pack_seq=64,
                                  group_baseline=True),
                   prompt_source=RepeatingSampler(task, group=4), **CPU)
    log = p.run()
    assert len(log) == 3
    assert all(np.isfinite(r["loss"]) for r in log)
    if cache == "paged":
        e = p.engine
        assert e.prefix_forks > 0 and e.prompt_prefills < e.prefix_forks
        e.tables.check()


# ---------------------------------------------------------------------------
# system behaviour
# ---------------------------------------------------------------------------

def test_ess_stays_high_during_training():
    """Paper Fig. 6b: PipelineRL's ESS stays near 1 despite nonzero lag."""
    task = MathTask(max_operand=3, ops="+")
    cfg = port_tiny.config(vocab_size=task.tok.vocab_size, d_model=64,
                           n_layers=1)
    params = M.init_params(cfg, 0, **CPU)
    p = PipelineRL(cfg, params, task, EngineConfig(n_slots=8, max_len=16),
                   PipelineConfig(batch_size=8, n_opt_steps=8, n_chips=8,
                                  train_chips=4, pack_rows=3, pack_seq=64),
                   trainer=Trainer(cfg, params, adam=AdamConfig(lr=1e-3),
                                   **CPU), **CPU)
    log = p.run()
    for r in log[2:]:
        assert r["ess"] > 0.7, r
    assert any(r["max_lag"] > 0 for r in log[2:])


def test_quickstart_configuration():
    """examples/quickstart.py's configuration on the port, 4 of its 10
    steps: two engines, streamed broadcast, version stamps that reach the
    engines and a decode pause charged to every update."""
    task = MathTask(max_operand=3, ops="+")
    cfg = port_tiny.config(vocab_size=task.tok.vocab_size)
    params = M.init_params(cfg, 0, **CPU)
    p = PipelineRL(
        cfg, params, task,
        EngineConfig(n_slots=16, max_len=16, prefill_chunk=8),
        PipelineConfig(batch_size=8, n_opt_steps=4, n_chips=8, train_chips=4,
                       pack_rows=3, pack_seq=64, n_engines=2,
                       broadcast="streamed"),
        trainer=Trainer(cfg, params, rl=RLConfig(entropy_coef=0.003),
                        adam=AdamConfig(lr=1e-3), **CPU), **CPU)
    log = p.run()
    assert [r["version"] for r in log] == [1, 2, 3, 4]
    assert all(np.isfinite([r["reward"], r["ess"], r["loss"]]).all()
               for r in log)
    assert sum(e.tokens_generated for e in p.engines) > 0
    assert all(e.version > 0 for e in p.engines)
    bs = p.broadcast_stats()
    assert all(0 < e["pause_per_update"] for e in bs["engines"])


# ---------------------------------------------------------------------------
# parity with the JAX package's PipelineRL
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


def _grouped(task, cache):
    return RepeatingSampler(task, group=4) if cache == "paged" else task.sample


@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_pipeline_matches_jax_pipeline(cache):
    """3 optimizer steps of both packages' PipelineRL from the same weights
    and prompts at temperature 1e-4. Paged: GRPO groups of 4 prefilled once
    and forked, the port decoding through its paged kernel."""
    jtask, task = JaxTask(max_operand=3, ops="+"), MathTask(max_operand=3,
                                                           ops="+")
    V = task.tok.vocab_size
    jcfg = jax_tiny(vocab_size=V, d_model=64, n_layers=2)
    tcfg = port_tiny.config(vocab_size=V, d_model=64, n_layers=2)
    tree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(0))))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, **CPU)
    ec = dict(n_slots=8, max_len=16, temperature=1e-4, prefill_chunk=4,
              cache=cache, page_size=4)
    pc = dict(batch_size=8, n_opt_steps=3, n_chips=8, train_chips=4,
              pack_rows=3, pack_seq=64, broadcast="streamed",
              broadcast_chunks=4, group_baseline=cache == "paged")
    J = JaxPipelineRL(jcfg, jp, jtask, JaxEngineConfig(**ec),
                      JaxPipelineConfig(**pc), trainer=JaxTrainer(jcfg, jp),
                      prompt_source=_grouped(jtask, cache))
    T = PipelineRL(tcfg, tp, task,
                   EngineConfig(**ec, paged_attention="kernel"),
                   PipelineConfig(**pc), trainer=Trainer(tcfg, tp, **CPU),
                   prompt_source=_grouped(task, cache), **CPU)
    fj, ft = _trace(J.loop), _trace(T.loop)
    jlog, tlog = J.run(), T.run()
    assert ft == fj                                  # the event schedule
    assert len(tlog) == len(jlog) == 3
    for a, b in zip(jlog, tlog):
        for k in ("version", "samples", "time", "reward", "max_lag",
                  "mean_lag", "mean_len", "fill", "queue_depth"):
            assert b[k] == a[k], k
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
    je, te = J.engine, T.engine
    for k in ("version", "tokens_generated", "prefill_tokens",
              "prompt_prefills", "prefix_forks", "pages_copied"):
        assert getattr(te, k) == getattr(je, k), k
    assert te.version >= 1
    if cache == "paged":
        assert te.prefix_forks > 0
        assert te.allocator.live_pages == je.allocator.live_pages
        te.tables.check()
    jb, tb = J.broadcast_stats(), T.broadcast_stats()
    for k in ("updates_applied", "streams_completed", "pause_total"):
        assert tb["engines"][0][k] == jb["engines"][0][k], k
    assert T.lag_stats()["histogram"] == J.lag_stats()["histogram"]


def test_learning_configuration_runs_in_both_packages(capsys):
    """The configuration of test_system.py::test_pipeline_rl_learns, which
    is red in the JAX package (ROADMAP.md C.1): no learning is asserted.
    Both packages run its 60 steps; the reward curves (means of 10 steps)
    are printed side by side, and the port's run must complete with finite
    losses and rewards in the task's range."""
    curves = {}
    for name in ("jax", "port"):
        if name == "jax":
            task = JaxTask(max_operand=3, ops="+")
            cfg = jax_tiny(vocab_size=task.tok.vocab_size, d_model=96,
                           n_layers=2)
            params = tree_values(JM.init_params(cfg, jax.random.PRNGKey(0)))
            trainer = JaxTrainer(cfg, params,
                                 rl=JaxRLConfig(entropy_coef=0.003),
                                 adam=JaxAdamConfig(lr=3e-3))
            p = JaxPipelineRL(cfg, params, task,
                              JaxEngineConfig(n_slots=16, max_len=16),
                              JaxPipelineConfig(batch_size=16, n_opt_steps=60,
                                                n_chips=8, train_chips=4,
                                                pack_rows=4, pack_seq=80),
                              trainer=trainer)
        else:
            task = MathTask(max_operand=3, ops="+")
            cfg = port_tiny.config(vocab_size=task.tok.vocab_size,
                                   d_model=96, n_layers=2)
            params = M.init_params(cfg, 0, **CPU)
            trainer = Trainer(cfg, params, rl=RLConfig(entropy_coef=0.003),
                              adam=AdamConfig(lr=3e-3), **CPU)
            p = PipelineRL(cfg, params, task,
                           EngineConfig(n_slots=16, max_len=16),
                           PipelineConfig(batch_size=16, n_opt_steps=60,
                                          n_chips=8, train_chips=4,
                                          pack_rows=4, pack_seq=80),
                           trainer=trainer, **CPU)
        log = p.run()
        rewards = [r["reward"] for r in log]
        curves[name] = [round(float(np.mean(rewards[i:i + 10])), 4)
                        for i in range(0, 60, 10)]
        if name == "port":
            assert len(log) == 60
            assert all(np.isfinite(r["loss"]) for r in log)
            assert all(-2.0 <= x <= 1.0 for x in rewards)
    with capsys.disabled():
        print(f"\nreward, means of 10 steps: jax {curves['jax']}, "
              f"port {curves['port']}")


def test_pipeline_refuses_what_is_not_ported(setup):
    task, cfg, params = setup
    for kw in ({"fault_plan": object()}, {"mesh": object()},
               {"rules": object()}):
        with pytest.raises(NotImplementedError, match="A.7"):
            PipelineRL(cfg, params, task, EngineConfig(),
                       PipelineConfig(), **CPU, **kw)
