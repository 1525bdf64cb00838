"""The port's pool scheduling and bounded-staleness gate on the CPU: twins
of the non-Server cases of `test_scheduler.py` (heterogeneous engine
speeds, timed preemption, the PoolRouter policies) and the `max_lag` and
stamp cases of `test_lag.py`.

Pipelines run in both packages from the same weights and prompts at
temperature 1e-4 and must take the same course (`torch_twin.assert_same_run`);
the routers and preemption windows are driven with the same scripted
inputs in both.
"""
import functools

import numpy as np
import pytest

from repro.core import events as JE
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.core.rollout import GenerationEngine as JaxEngine
from repro.core.sim import HardwareModel as JaxHardwareModel
from repro.data.math_task import Problem as JaxProblem
from repro_torch import (EngineConfig, GenerationEngine, HardwareModel,
                         PipelineConfig, PipelineRL)
from repro_torch.core.events import ActorStage, EventLoop, PoolRouter
from repro_torch.data.math_task import Problem
from repro_torch.data.packing import pack
from torch_twin import (CPU, GREEDY, assert_same_run, one_thread, pipe,
                        tasks, weights)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


# ---------------------------------------------------------------------------
# per-engine HardwareModel overrides (heterogeneous pool)
# ---------------------------------------------------------------------------

def test_hardware_model_speed_scaling():
    hw, jhw = HardwareModel(), JaxHardwareModel()
    fast = hw.scaled(2.0)
    assert fast.step_cost(8) == pytest.approx(hw.step_cost(8) / 2.0)
    assert fast.prefill_time(64, 4) == pytest.approx(
        hw.prefill_time(64, 4) / 2.0)
    assert fast.train_time(100, 4) == hw.train_time(100, 4)
    assert fast.broadcast_time(1e5) == hw.broadcast_time(1e5)
    assert fast.scaled(2.0).speed == pytest.approx(4.0)
    jfast = jhw.scaled(2.0)
    for h in (1, 8, 64):
        assert fast.step_cost(h) == jfast.step_cost(h)
    assert fast.prefill_time(64, 4) == jfast.prefill_time(64, 4)


HETERO = dict(ec=dict(n_slots=4, max_len=20), speeds=[3.0, 1.0], hw=False)


@functools.lru_cache(maxsize=None)
def _runs(name):
    kw = SCENARIOS[name]
    j, t = pipe(False, **kw), pipe(True, **kw)
    assert_same_run(j, t)
    return j, t


SCENARIOS = {
    "hetero": HETERO,
    "affinity": dict(ec=dict(n_slots=4, max_len=20), speeds=[2.0, 1.0],
                     hw=False, steps=3, seed=7, task_kw=dict(seed=3),
                     pc=dict(router="length_affinity")),
    "bound0": dict(lag=True, pc=dict(max_lag=0)),
    "bound2": dict(lag=True),
    "free": dict(lag=True, pc=dict(max_lag=None)),
    "unbounded": dict(),
}


def test_hetero_pool_fast_engine_finishes_more():
    _, t = _runs("hetero")
    p = t.p
    assert len(p.log) == 4
    fast, slow = p.engines
    assert fast.tokens_generated > slow.tokens_generated > 0
    rs = p.router_stats()
    assert rs["engines"][0]["assigned"] > rs["engines"][1]["assigned"]


def test_engine_speeds_length_mismatch_raises():
    _, cfg, _, params = weights()
    _, task = tasks()
    with pytest.raises(ValueError):
        PipelineRL(cfg, params, task, EngineConfig(n_slots=4, max_len=20),
                   PipelineConfig(batch_size=4, n_opt_steps=2, n_engines=2,
                                  engine_speeds=[1.0]), **CPU)


# ---------------------------------------------------------------------------
# timed preemption windows
# ---------------------------------------------------------------------------

def _drive_actor(port, n_rollouts, preempt=None, publish_at=None,
                 version=5):
    """One ActorStage on its own loop, unit step cost, an optional window
    and an atomic publication of the SAME params (only stamps and timing
    can differ)."""
    jcfg, tcfg, jp, tp = weights()
    jtask, ttask = tasks(seed=0)
    ec = dict(n_slots=4, max_len=16, temperature=GREEDY)
    if port:
        eng = GenerationEngine(tcfg, tp, EngineConfig(**ec), ttask.sample,
                               seed=11, **CPU)
        loop, stage, task, params = EventLoop(), ActorStage, ttask, tp
    else:
        eng = JaxEngine(jcfg, jp, JaxEngineConfig(**ec), jtask.sample,
                        seed=11)
        loop, stage, task, params = JE.EventLoop(), JE.ActorStage, jtask, jp
    got = []
    actor = stage(loop, eng, task=task, name="a", step_cost=lambda h: 1.0,
                  deliver=lambda rs, t: got.extend(rs))
    if preempt is not None:
        actor.preempt(*preempt)
    if publish_at is not None:
        actor.deliver_atomic(publish_at, params, version, pause=0.0)
    actor.start(0.0)
    loop.run(until=lambda: len(got) >= n_rollouts)
    return actor, loop, got[:n_rollouts]


@functools.lru_cache(maxsize=None)
def _actors(preempt):
    """(JAX, port) preemption runs, equal in tokens, stamps and times."""
    out = [_drive_actor(port, 8, preempt=preempt, publish_at=30.0)
           for port in (False, True)]
    (ja, jl, jg), (ta, tl, tg) = out
    assert len(tg) == len(jg) == 8
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.weight_versions, a.weight_versions)
        assert b.finished_at == a.finished_at
    assert (ta.time, ta.preempt_total, ta.preemptions_taken) == \
        (ja.time, ja.preempt_total, ja.preemptions_taken)
    return out[1]


def test_preemption_resume_no_rollout_lost():
    a, _, got_a = _actors(None)
    b, _, got_b = _actors((3.0, 50.0))
    for ra, rb in zip(got_a, got_b):
        assert ra.prompt_len == rb.prompt_len
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
    assert b.preemptions_taken == 1
    assert b.preempt_total == pytest.approx(50.0)
    assert a.preempt_total == 0.0
    assert b.time > a.time


def test_preemption_weight_versions_stay_exact():
    b, _, got = _actors((3.0, 50.0))
    assert b.engine.version == 5 and b.updates_applied == 1
    for r in got:
        vers = r.weight_versions[r.prompt_len:]
        assert set(np.unique(vers)) <= {0, 5}
        assert (np.diff(vers) >= 0).all()
    assert max(r.weight_versions.max() for r in got) == 5


def test_preemption_windows_compose():
    class _Eng:
        n_active = 0
        ec = EngineConfig(n_slots=1, max_len=8)

        def refill(self, now):
            return 0

    loop = EventLoop()
    a = ActorStage(loop, _Eng(), auto_refill=False, chain=False)
    a.preempt(1.0, 2.0)
    a.preempt(3.0, 4.0)
    a.preempt(0.0, -1.0)
    assert a._preempt_until(2.0) == pytest.approx(7.0)
    assert a._preempt_until(7.0) is None
    assert a._preempt == []


# ---------------------------------------------------------------------------
# PoolRouter policies, against the JAX router on the same script
# ---------------------------------------------------------------------------

class _FakeEngine:
    def __init__(self, n_slots=4, max_len=16, active=0, ncached=1):
        self.ec = EngineConfig(n_slots=n_slots, max_len=max_len)
        self._host_active = np.zeros(n_slots, bool)
        self._host_active[:active] = True
        self._host_ncached = np.full(n_slots, ncached, np.int64)


def _scripted_source(lengths, cls=Problem):
    probs = [cls([1] * n, 0) for n in lengths]
    return lambda: probs.pop(0) if probs else None


def _routers(lengths, engines, speeds=None, **kw):
    """(port router, JAX router) on the same script and engines."""
    out = []
    for router, cls in ((PoolRouter, Problem), (JE.PoolRouter, JaxProblem)):
        r = router(_scripted_source(lengths, cls), **kw)
        r.attach(engines(), speeds=speeds)
        out.append(r)
    return out


def _pulls(routers, order):
    got = []
    for r in routers:
        got.append([None if p is None else len(p.prompt_ids)
                    for p in (r.request(i) for i in order)])
    assert got[0] == got[1]
    assert routers[0].stats() == routers[1].stats()
    return got[0]


def test_router_fifo_passthrough_order():
    rs = _routers([3, 10, 5, 8], lambda: [_FakeEngine(), _FakeEngine()],
                  policy="fifo")
    assert _pulls(rs, [0, 1, 0, 1, 0]) == [3, 10, 5, 8, None]
    assert [e["assigned"] for e in rs[0].stats()["engines"]] == [2, 2]


def test_router_length_affinity_routes_long_to_fast():
    rs = _routers([3, 10, 5, 8], lambda: [_FakeEngine(), _FakeEngine()],
                  speeds=[2.0, 1.0], policy="length_affinity", lookahead=4)
    assert _pulls(rs, [0, 1, 0, 1]) == [10, 3, 8, 5]
    st = rs[0].stats()
    assert st["engines"][0]["prompt_tokens"] == 18
    assert st["engines"][1]["prompt_tokens"] == 8


def test_router_shortest_queue_declines_deep_engine():
    def engines():
        return [_FakeEngine(active=4, ncached=1), _FakeEngine(active=0)]

    rs = _routers([4, 4, 4], engines, policy="shortest_queue")
    assert _pulls(rs, [0, 1]) == [None, 4]
    st = rs[0].stats()
    assert st["engines"][0]["declined"] == 1
    assert st["engines"][1]["assigned"] == 1
    for r in rs:
        r.engines[0]._host_active[:] = False
    assert _pulls(rs, [0]) == [4]


def test_router_rejects_unknown_policy():
    with pytest.raises(ValueError):
        PoolRouter(lambda: None, policy="round_robin")


def test_router_determinism_under_sim_clock():
    """Two identically seeded heterogeneous runs with length-affinity
    routing are identical, and equal the JAX package's."""
    _, t = _runs("affinity")
    again = pipe(True, **SCENARIOS["affinity"])
    assert again.fired == t.fired
    assert [r["reward"] for r in again.p.log] == \
        [r["reward"] for r in t.p.log]
    assert again.p.router_stats() == t.p.router_stats()
    assert [e.tokens_generated for e in again.p.engines] == \
        [e.tokens_generated for e in t.p.engines]


# ---------------------------------------------------------------------------
# stamps and the max_lag barrier (test_lag.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["slots", "paged"])
@pytest.mark.parametrize("n_engines", [1, 2])
def test_stamp_exactness_across_streamed_installs(cache, n_engines):
    """Rollouts crossing streamed installs carry stamps that pack() turns
    into lag == V - stamp elementwise, as in the JAX package's run."""
    kw = dict(steps=6, n_engines=n_engines,
              ec=dict(cache=cache, page_size=4))
    j, t = pipe(False, **kw), pipe(True, **kw)
    assert_same_run(j, t)
    rec = t.rollouts
    assert any(len(np.unique(r.weight_versions[r.prompt_len:])) >= 2
               for r in rec)
    V = t.p.trainer.version + 3
    out = pack(rec, 8, 48, trainer_version=V)
    comp = out["loss_mask"] > 0
    expect = np.maximum(V - out["weight_versions"], 0) * comp
    np.testing.assert_array_equal(out["lag"], expect.astype(np.int32))
    assert np.all(out["lag"][~comp] == 0)


@pytest.mark.parametrize("bound", [0, 2])
def test_max_lag_bounds_every_trained_token(bound):
    _, t = _runs(f"bound{bound}")
    assert len(t.p.log) == 4
    ls = t.p.lag_stats()
    assert ls["bound"] == bound and ls["trained_tokens"] > 0
    assert ls["histogram"] and max(ls["histogram"]) <= bound
    assert ls["max_lag"] <= bound
    assert ls["gate"]["blocks"] > 0
    assert sum(ls["histogram"].values()) == ls["trained_tokens"]


def test_max_lag_zero_is_conventional_all_fresh():
    _, t = _runs("bound0")
    assert set(t.p.lag_stats()["histogram"]) == {0}
    assert all(r["max_lag"] == 0 and r["mean_lag"] == 0 for r in t.p.log)


def test_bound_interpolates_throughput_and_lag():
    _, bounded = _runs("bound0")
    _, free = _runs("free")
    assert free.p.log[-1]["time"] < bounded.p.log[-1]["time"]
    fl = free.p.lag_stats()
    assert fl["max_lag"] > 0 and fl["masked_tokens"] == 0
    assert bounded.p.lag_stats()["gate"]["parks"] > 0


def test_max_lag_validation():
    _, cfg, _, params = weights()
    _, task = tasks()
    ec = EngineConfig(n_slots=8, max_len=16)
    base = dict(batch_size=4, n_opt_steps=2, n_chips=8, train_chips=4,
                pack_rows=2, pack_seq=48)
    for bad in (dict(max_lag=-1), dict(max_lag=1, update_every=2)):
        with pytest.raises(ValueError):
            PipelineRL(cfg, params, task, ec, PipelineConfig(**base, **bad),
                       **CPU)


def test_lag_stats_unbounded_invariants():
    _, t = _runs("unbounded")
    ls = t.p.lag_stats()
    assert ls["bound"] is None and "gate" not in ls
    assert sum(ls["histogram"].values()) == ls["trained_tokens"] > 0
    assert 0 <= ls["mean_lag"] <= ls["max_lag"]
    for e in ls["engines"]:
        assert e["behind"] >= 0 and e["lag_pauses"] == 0
    assert max(r["max_lag"] for r in t.p.log) == ls["max_lag"]
