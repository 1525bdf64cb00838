"""The port's fault injection on the CPU: twins of `test_faults.py`.

`FaultPlan` and its oracles are copies of the JAX package's numpy code, so
they must give the same faults and the same draws. Each fault kind then
runs through both packages' `PipelineRL` from the same weights and prompts
at temperature 1e-4: the event times, rollouts, counters and fault logs
must be equal and the losses within 1e-4 relative. Inside the port, two
runs of one plan are bit-equal, and a trainer restored from its checkpoint
takes the uninterrupted run's next step bit for bit.
"""
import functools
import os

import numpy as np
import pytest
import torch

from repro.core import events as JE
from repro.core.queues import SampleQueue as JaxSampleQueue
from repro.core.sim import HardwareModel as JaxHardwareModel
from repro_torch import Trainer
from repro_torch.checkpoint import checkpoint
from repro_torch.core import events as TE
from repro_torch.core.events import (EventLoop, FaultPlan, PreprocessStage,
                                     WeightBroadcaster)
from repro_torch.core.queues import QueueUnderflow, SampleQueue
from repro_torch.core.sim import HardwareModel
from repro_torch.core.weights import tree_flatten
from repro_torch.data.packing import Rollout, pack
from torch_twin import (CPU, HW, assert_same_run, leaves_equal, one_thread,
                        pipe, torch_leaves, weights)

KILL_AT, RESTORE_AFTER = 120.0, 240.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


# ---------------------------------------------------------------------------
# FaultPlan: construction, parse DSL, replayable chunk-loss oracle
# ---------------------------------------------------------------------------

SPEC = "engine:1@300r150, trainer@500r100, pre@400, link:0@600d300p0.5"


def test_fault_plan_parse_dsl():
    plan = FaultPlan.parse(SPEC)
    assert repr(plan) == repr(JE.FaultPlan.parse(SPEC))
    kinds = [f.kind for f in plan.faults]
    assert kinds == ["engine_crash", "trainer_crash", "preprocess_fail",
                     "link_degrade"]
    e, t, _, l = plan.faults
    assert (e.engine, e.at, e.restart_after) == (1, 300.0, 150.0)
    assert (t.at, t.restart_after) == (500.0, 100.0)
    assert (l.engine, l.at, l.duration, l.drop_prob) == (0, 600.0, 300.0, 0.5)
    assert FaultPlan.parse("engine:0@10").faults[0].restart_after is None
    assert repr(FaultPlan.parse("chaos:7:900", n_engines=3)) == repr(
        JE.FaultPlan.parse("chaos:7:900", n_engines=3))
    with pytest.raises(ValueError):
        FaultPlan.parse("flux-capacitor@88")


def test_fault_plan_chaos_seed_deterministic():
    kw = dict(horizon=1000.0, n_engines=4, n_crashes=3, link_windows=2)
    a, b = FaultPlan.chaos(42, **kw), FaultPlan.chaos(42, **kw)
    assert [vars(f) for f in a.faults] == [vars(f) for f in b.faults]
    assert repr(a) == repr(JE.FaultPlan.chaos(42, **kw))
    c = FaultPlan.chaos(43, **kw)
    assert [vars(f) for f in a.faults] != [vars(f) for f in c.faults]


def test_chunk_loss_oracle_is_order_independent():
    plan = FaultPlan(seed=9).degrade_link(at=0.0, duration=1e9,
                                          drop_prob=0.5)
    jplan = JE.FaultPlan(seed=9).degrade_link(at=0.0, duration=1e9,
                                              drop_prob=0.5)
    keys = [(e, v, k, a) for e in range(2) for v in range(3)
            for k in range(4) for a in range(2)]
    fwd = {key: plan.chunk_lost(*key, t=5.0) for key in keys}
    rev = {key: plan.chunk_lost(*key, t=5.0) for key in reversed(keys)}
    assert fwd == rev
    assert fwd == {key: jplan.chunk_lost(*key, t=5.0) for key in keys}
    assert any(fwd.values()) and not all(fwd.values())
    assert not plan.chunk_lost(0, 0, 0, 0, t=-1.0)
    assert FaultPlan().degrade_link(at=0.0, duration=10.0).chunk_lost(
        0, 0, 0, 0, t=5.0)


class _StubActor:
    failed = False

    def __init__(self):
        self.streams = []

    def deliver_stream(self, params, version, arrivals, tokens=None, **kw):
        self.streams.append((list(arrivals), list(tokens)))


@pytest.mark.parametrize("kind", ["link_degrade", "chunk_corrupt"])
def test_lossy_broadcast_deterministic_and_terminating(kind):
    """The serialized chunk cursor over a lossy (or corrupting) link: the
    arrivals and integrity tokens equal the JAX broadcaster's, replay
    equal, and stay strictly increasing."""
    def plan(mod):
        p = mod.FaultPlan(seed=5)
        build = p.degrade_link if kind == "link_degrade" else p.chunk_corrupt
        return build(at=0.0, duration=1e9, drop_prob=0.4)

    runs = []
    for mod, params in ((TE, {"w": torch.zeros((64, 64))}),
                        (TE, {"w": torch.zeros((64, 64))}),
                        (JE, {"w": np.zeros((64, 64), np.float32)})):
        actors = [_StubActor(), _StubActor()]
        hw = (HardwareModel if mod is TE else JaxHardwareModel)(**HW)
        bc = mod.WeightBroadcaster(hw, actors, mode="streamed", n_chunks=8,
                                   fault_plan=plan(mod))
        bc.publish(params, version=3, now=0.0)
        runs.append(([a.streams for a in actors], bc.chunks_lost,
                     bc.chunks_corrupt, bc.retransmit_wait))
        assert bc.retransmit_wait > 0
        assert (bc.chunks_lost if kind == "link_degrade"
                else bc.chunks_corrupt) > 0
    assert runs[0] == runs[1] == runs[2]
    for streams in runs[0][0]:
        for arrivals, _ in streams:
            assert all(b > a for a, b in zip(arrivals, arrivals[1:]))


def test_broadcaster_skips_failed_actors():
    class StubActor:
        def __init__(self, failed):
            self.failed = failed
            self.n = 0

        def deliver_atomic(self, *a, **kw):
            self.n += 1

    alive, dead = StubActor(False), StubActor(True)
    bc = WeightBroadcaster(HardwareModel(**HW), [alive, dead], mode="atomic")
    bc.publish({"w": torch.zeros(4)}, version=1, now=0.0)
    assert (alive.n, dead.n) == (1, 0)
    assert bc.deliveries_skipped == 1


# ---------------------------------------------------------------------------
# SampleQueue recovery surface
# ---------------------------------------------------------------------------

def _mk_rollout(i, length=4):
    return Rollout(tokens=np.full(length, i % 7, np.int32), prompt_len=1,
                   behavior_logprobs=np.zeros(length, np.float32),
                   reward=float(i), weight_versions=np.zeros(length, np.int32),
                   prompt_key=i)


def test_requeue_front_order_and_counters():
    for q in (SampleQueue(), JaxSampleQueue()):
        q.put([_mk_rollout(i) for i in range(4)])
        q.requeue_front(q.pop(2))
        assert [r.prompt_key for r in q.pop(4)] == [0, 1, 2, 3]
        assert (q.total_put, q.requeued) == (4, 2)


def test_requeue_front_respects_maxsize():
    q = SampleQueue(maxsize=3)
    q.put([_mk_rollout(i) for i in range(3)])
    q.requeue_front([_mk_rollout(97), _mk_rollout(98)])
    assert len(q) == 3 and q.dropped == 2
    assert [r.prompt_key for r in q.pop(3)] == [0, 1, 2]


def test_queue_underflow_carries_depth():
    q = SampleQueue()
    q.put([_mk_rollout(0)])
    with pytest.raises(QueueUnderflow) as ei:
        q.pop(3)
    assert (ei.value.depth, ei.value.requested) == (1, 3)
    assert isinstance(ei.value, ValueError)


# ---------------------------------------------------------------------------
# checkpoint hardening
# ---------------------------------------------------------------------------

def _tree():
    return {"layer": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                      "b": torch.ones(3)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_normalizes_suffix(tmp_path):
    bare = str(tmp_path / "ckpt")
    checkpoint.save(bare, _tree())
    assert os.path.exists(bare + ".npz")
    like = {"layer": {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
            "step": torch.tensor(0, dtype=torch.int32)}
    out = checkpoint.load(bare, like)
    assert leaves_equal(tree_flatten(out)[0], tree_flatten(_tree())[0])
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_checkpoint_corrupt_file_raises_checkpoint_error(tmp_path):
    path = str(tmp_path / "bad.npz")
    with open(path, "wb") as f:
        f.write(b"this is not an npz archive")
    with pytest.raises(checkpoint.CheckpointError, match="corrupt"):
        checkpoint.load(path, _tree())
    with pytest.raises(FileNotFoundError):
        checkpoint.load(str(tmp_path / "absent.npz"), _tree())


def test_checkpoint_key_and_shape_mismatches_are_named(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, _tree())
    like = _tree()
    like["extra"] = torch.zeros(2)
    del like["step"]
    with pytest.raises(checkpoint.CheckpointError) as ei:
        checkpoint.load(path, like)
    assert "extra" in str(ei.value) and "step" in str(ei.value)
    like = _tree()
    like["layer"]["w"] = torch.zeros(5, 5)
    with pytest.raises(checkpoint.CheckpointError, match="layer/w"):
        checkpoint.load(path, like)


# ---------------------------------------------------------------------------
# trainer crash-restart: checkpoint parity
# ---------------------------------------------------------------------------

def _rollouts(cfg, seed):
    rng = np.random.default_rng(seed)
    rolls = []
    for i in range(4):
        toks = rng.integers(0, cfg.vocab_size, size=10).astype(np.int32)
        rolls.append(Rollout(
            tokens=toks, prompt_len=3,
            behavior_logprobs=rng.normal(size=10).astype(np.float32) - 2.0,
            reward=float(rng.choice([-1.0, 1.0])),
            weight_versions=np.zeros(10, np.int32), prompt_key=i))
    return rolls


def _batch(cfg, seed):
    b = pack(_rollouts(cfg, seed), 2, 48)
    b.pop("packing_stats")
    return b


def test_trainer_restore_step_parity(tmp_path):
    """Restoring the checkpoint and re-running the next batch equals the
    uninterrupted run bit for bit: params, Adam moments and version."""
    _, cfg, _, params = weights()
    b1, b2 = _batch(cfg, 1), _batch(cfg, 2)
    tr = Trainer(cfg, params, **CPU)
    tr.step(b1)
    ckpt = tr.save(str(tmp_path / "trainer_latest"))
    tr.step(b2)
    uninterrupted = torch_leaves(tr.state)
    tr.step(_batch(cfg, 3))
    assert tr.restore(ckpt) == 1
    tr.step(b2)
    assert leaves_equal(torch_leaves(tr.state), uninterrupted)
    assert tr.version == 2


def test_crash_mid_step_rolls_back_to_the_prestep_state(tmp_path):
    """`TrainerStage.crash` during an in-flight step rolls the trainer back
    to its pre-step state, which is a true snapshot because the step makes
    new tensors; after the restore from its checkpoint, the next step
    equals the uninterrupted run's bit for bit."""
    _, cfg, _, params = weights()
    plain = Trainer(cfg, params, **CPU)
    plain.step(_batch(cfg, 1))
    plain.step(_batch(cfg, 2))
    want = torch_leaves(plain.state)

    tr = Trainer(cfg, params, **CPU)
    loop = EventLoop()
    ts = TE.TrainerStage(loop, tr, train_time=lambda n: 10.0, pack_rows=2,
                         pack_seq=48, ckpt_dir=str(tmp_path), ckpt_every=1)
    ts.submit(_rollouts(cfg, 1), 0.0)
    loop.run()
    assert tr.version == 1 and ts.last_ckpt_version == 1
    before = torch_leaves(tr.state)
    ts.submit(_rollouts(cfg, 2), loop.now)   # stepped now, lands at +10
    assert tr.version == 2 and ts.busy
    ts.crash(loop.now + 5.0)
    assert ts.steps_lost == 1 and tr.version == 1 and len(tr.history) == 1
    assert leaves_equal(torch_leaves(tr.state), before)
    loop.run()                                # the stale completion no-ops
    assert ts.last_ckpt_version == 1
    assert ts.restore(loop.now) == 1          # from trainer_latest
    ts.submit(_rollouts(cfg, 2), loop.now)
    loop.run()
    assert tr.version == 2
    assert leaves_equal(torch_leaves(tr.state), want)


# ---------------------------------------------------------------------------
# fault kinds through PipelineRL, against the JAX package
# ---------------------------------------------------------------------------

def _trainer_crash(m):
    return m.FaultPlan().trainer_crash(at=KILL_AT + RESTORE_AFTER,
                                       restart_after=60.0)


def _engine_kill(m):
    return m.FaultPlan().engine_crash(at=KILL_AT, engine=1)


def _engine_restore(m):
    return m.FaultPlan().engine_crash(at=KILL_AT, engine=1,
                                      restart_after=RESTORE_AFTER)


def _failstop(m):
    return (m.FaultPlan(seed=3)
            .engine_crash(at=KILL_AT, engine=1, restart_after=RESTORE_AFTER)
            .degrade_link(at=KILL_AT, duration=RESTORE_AFTER, drop_prob=0.3))


def _gray(m):
    return (m.FaultPlan(seed=7)
            .engine_slowdown(at=50.0, duration=150.0, engine=0, factor=6.0)
            .engine_hang(at=KILL_AT, engine=1, restart_after=80.0)
            .chunk_corrupt(at=0.0, duration=1500.0, drop_prob=0.5)
            .nan_step(at=100.0, count=2)
            .poison_prompt(5))


SCENARIOS = {
    "trainer_crash": dict(plan=_trainer_crash, ckpt=True, ckpt_every=2),
    "engine_kill": dict(plan=_engine_kill),
    "engine_restore": dict(plan=_engine_restore, steps=6),
    "failstop": dict(plan=_failstop),
    "gray": dict(plan=_gray),
    "failstop-lag": dict(plan=_failstop, lag=True),
    "gray-lag": dict(plan=_gray, lag=True),
}


@functools.lru_cache(maxsize=None)
def _runs(name):
    """(JAX run, port run) of a scenario, compared in full."""
    j = pipe(False, **SCENARIOS[name])
    t = pipe(True, **SCENARIOS[name])
    assert_same_run(j, t)
    return j, t


def test_pipeline_trainer_crash_restores_and_finishes():
    _, t = _runs("trainer_crash")
    p = t.p
    tr = p.pool_stats()["trainer"]
    assert p.trainer.version >= 4
    assert tr["crashes"] == 1 and tr["recoveries"] == 1
    assert tr["ckpts_saved"] >= 2
    assert os.path.exists(os.path.join(p.pc.ckpt_dir, "trainer_latest.npz"))
    kinds = [e["kind"] for e in p.fault_log]
    assert kinds.count("trainer_crash") == 1
    assert kinds.count("trainer_restore") == 1
    # the step in flight at the crash was lost with its log entry and
    # retrained after the restore from the seed checkpoint
    assert tr["steps_lost"] == 1
    assert [r["version"] for r in p.log] == [1, 2, 3, 4]
    restore = next(e for e in p.fault_log if e["kind"] == "trainer_restore")
    assert p.log[0]["time"] > restore["at"]


def test_engine_kill_salvages_and_requeues():
    _, t = _runs("engine_kill")
    p = t.p
    ps = p.pool_stats()
    assert p.trainer.version >= 4
    victim = ps["engines"][1]
    assert victim["failures"] == 1 and not victim["alive"]
    assert victim["rollouts_lost"] > 0
    assert ps["prompts_salvaged"] == victim["prompts_salvaged"] > 0
    assert ps["prompts_requeued"] == ps["prompts_salvaged"]
    assert ps["requeues_readmitted"] == ps["prompts_requeued"]
    assert ps["requeue_latency_max"] >= ps["requeue_latency_mean"] >= 0.0


def test_engine_restore_catches_up_weights():
    _, t = _runs("engine_restore")
    p = t.p
    a = p.actors[1]
    assert a.failures == 1 and a.recoveries == 1
    assert a.downtime == pytest.approx(RESTORE_AFTER)
    restores = [e for e in p.fault_log if e["kind"] == "engine_restore"]
    assert len(restores) == 1
    assert p.engines[1].version >= restores[0]["version"] > 0
    assert p.router.alive[1]


@pytest.mark.parametrize("lag", [False, True], ids=["plain", "lag"])
@pytest.mark.parametrize("kind", ["failstop", "gray"])
def test_chaos_replay_is_bit_equal(kind, lag):
    """Two runs of one plan in the port stream bit-equal rollouts and end
    on bit-equal parameters; the first equals the JAX package's run."""
    name = kind + ("-lag" if lag else "")
    _, t = _runs(name)
    again = pipe(True, **SCENARIOS[name])
    assert again.fired == t.fired
    assert again.digest() == t.digest()
    assert again.p.pool_stats() == t.p.pool_stats()


def test_elastic_add_and_detach_engine():
    def run(port):
        r = pipe(port, steps=2)
        p = r.p
        i = p.add_engine(speed=1.0)
        assert i == 2 and len(p.engines) == 3
        assert p.engines[i].version == p.trainer.version > 0
        p.run(4)
        assert p.router.assigned[i] > 0
        salvaged = p.detach_engine(i)
        assert p.actors[i].failed and not p.router.alive[i]
        p.run(5)
        assert p.trainer.version >= 5
        return r, salvaged

    (j, js), (t, ts) = run(False), run(True)
    assert ts == js
    assert_same_run(j, t)


# ---------------------------------------------------------------------------
# preprocessor failure: the in-flight batch survives via requeue_front
# ---------------------------------------------------------------------------

def test_preprocess_fail_requeues_in_flight_batch():
    class StubPre:
        def process(self, rollouts):
            return rollouts

        def stage_time(self, n_tokens):
            return 10.0

    class StubTrainerStage:
        def __init__(self):
            self.got = []

        def inbox_waiting(self):
            return 0

        def submit(self, rollouts, t, raw_reward=None):
            self.got.append([r.prompt_key for r in rollouts])

    loop = EventLoop()
    q = SampleQueue()
    ts = StubTrainerStage()
    pre = PreprocessStage(loop, StubPre(), q, batch_size=4,
                          trainer_stage=ts)
    q.put([_mk_rollout(i) for i in range(4)])
    pre.kick(0.0)
    assert pre.busy
    n = pre.fail(2.0)
    assert n == 4 and pre.batches_failed == 1
    assert pre.rollouts_requeued == 4
    assert pre.busy
    loop.run()
    assert ts.got == [[0, 1, 2, 3]]
    assert pre.fail(20.0) == 0
    assert pre.batches_failed == 2
