"""The port's gray-failure self-healing on the CPU: twins of `test_gray.py`.

Each pipeline scenario runs in both packages from the same weights and
prompts at temperature 1e-4 and must take the same course (event times,
rollouts, counters, fault log; losses within 1e-4 relative); the port's
own laws (the healthy run bit-equal with the watchdog and guard on and
off, bit-equal replays, the poisoned step a bitwise no-op) are asserted
inside the port.
"""
import functools
import io
import os
import zipfile

import numpy as np
import pytest
import torch

from repro.core import events as JE
from repro_torch import EngineConfig, GenerationEngine, Trainer
from repro_torch.checkpoint import checkpoint
from repro_torch.core import events as TE
from repro_torch.core.events import (EventLoop, Fault, FaultPlan,
                                     TrainerStage, _fault_sort_key,
                                     chunk_token, stream_digest)
from repro_torch.data.math_task import MathTask
from repro_torch.data.packing import Rollout, pack
from torch_twin import (CPU, assert_same_run, leaves_equal, one_thread, pipe,
                        torch_leaves, weights)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _vars(plan):
    return [vars(f) for f in plan.faults]


# ---------------------------------------------------------------------------
# FaultPlan: None-safe ordering, gray builders, DSL
# ---------------------------------------------------------------------------

def test_fault_sort_key_is_total_and_none_safe():
    def faults(mod):
        return [mod.Fault("chunk_corrupt", 10.0, engine=None, duration=5.0),
                mod.Fault("chunk_corrupt", 10.0, engine=0, duration=5.0),
                mod.Fault("engine_crash", 10.0, engine=0, restart_after=3.0),
                mod.Fault("engine_crash", 10.0, engine=0)]

    fs = faults(TE)
    fwd = sorted(fs, key=_fault_sort_key)
    rev = sorted(reversed(fs), key=_fault_sort_key)
    assert [vars(f) for f in fwd] == [vars(f) for f in rev]
    jfwd = sorted(faults(JE), key=JE._fault_sort_key)
    assert [vars(f) for f in fwd] == [vars(f) for f in jfwd]
    corr = [f for f in fwd if f.kind == "chunk_corrupt"]
    assert corr[0].engine is None and corr[1].engine == 0
    assert isinstance(fwd[0], Fault)


GRAY_SPEC = ("slow:0@300d200x4,hang:1@300r60,corrupt@300d200p0.5,"
             "nan@500x3,poison@7")


def test_gray_dsl_parse():
    plan = FaultPlan.parse(GRAY_SPEC, n_engines=2)
    assert repr(plan) == repr(JE.FaultPlan.parse(GRAY_SPEC, n_engines=2))
    kinds = [f.kind for f in plan.faults]
    assert kinds == ["engine_slowdown", "engine_hang", "chunk_corrupt",
                     "nan_step", "poison_prompt"]
    slow, hang, corr, nan, _ = plan.faults
    assert (slow.engine, slow.at, slow.duration, slow.factor) == (
        0, 300.0, 200.0, 4.0)
    assert (hang.engine, hang.at, hang.restart_after) == (1, 300.0, 60.0)
    assert (corr.engine, corr.duration, corr.drop_prob) == (None, 200.0, 0.5)
    assert (nan.at, nan.count) == (500.0, 3)
    assert plan.poison_ordinals() == [7]
    assert FaultPlan.parse("hang:0@10").faults[0].restart_after is None
    assert FaultPlan.parse("corrupt@10d5").faults[0].drop_prob == 1.0


def test_chaos_gray_knobs_deterministic():
    kw = dict(horizon=1000.0, n_engines=2, n_crashes=1, slowdowns=1,
              hangs=1, corrupt_windows=1, nan_bursts=1, poison_prompts=1)
    a, b = FaultPlan.chaos(seed=11, **kw), FaultPlan.chaos(seed=11, **kw)
    assert _vars(a) == _vars(b)
    assert repr(a) == repr(JE.FaultPlan.chaos(seed=11, **kw))
    assert _vars(a) != _vars(FaultPlan.chaos(seed=12, **kw))
    assert {"engine_slowdown", "engine_hang", "chunk_corrupt", "nan_step",
            "poison_prompt"} <= {f.kind for f in a.faults}
    old = FaultPlan.chaos(seed=11, horizon=1000.0, n_engines=2, n_crashes=1)
    assert all(f.kind in ("engine_crash", "link_degrade")
               for f in old.faults)


def test_slowdown_factor_windows():
    def plan(mod):
        return (mod.FaultPlan()
                .engine_slowdown(at=10.0, duration=10.0, engine=0, factor=3.0)
                .engine_slowdown(at=15.0, duration=10.0, engine=0,
                                 factor=2.0))

    p, jp = plan(TE), plan(JE)
    for e, t in ((0, 5.0), (0, 12.0), (0, 17.0), (1, 12.0)):
        assert p.slowdown_factor(e, t) == jp.slowdown_factor(e, t)
    assert [p.slowdown_factor(0, t) for t in (5.0, 12.0, 17.0)] == \
        [1.0, 3.0, 6.0]
    assert p.slowdown_factor(1, 12.0) == 1.0
    assert p.chunk_corrupted(0, 0, 0, 0, t=12.0) is False


# ---------------------------------------------------------------------------
# pipeline scenarios, against the JAX package
# ---------------------------------------------------------------------------

def _hang(m):
    return m.FaultPlan().engine_hang(at=120.0, engine=1, restart_after=60.0)


def _straggler(m):
    return m.FaultPlan().engine_slowdown(at=30.0, duration=600.0, engine=0,
                                         factor=8.0)


def _poison(m):
    return m.FaultPlan().poison_prompt(5)


def _corrupt(m):
    return m.FaultPlan(seed=5).chunk_corrupt(at=0.0, duration=1e9,
                                             drop_prob=0.5)


def _nan_burst(m):
    return m.FaultPlan().nan_step(at=360.0, count=4)


SCENARIOS = {
    "healthy": dict(interval=15.0),
    "hang": dict(plan=_hang, interval=15.0),
    "declared_slow": dict(speeds=[1.0, 0.25], interval=15.0),
    "straggler": dict(plan=_straggler, steps=8, interval=15.0),
    "poison": dict(plan=_poison, interval=15.0),
    "corrupt": dict(plan=_corrupt, interval=15.0),
    "nan_burst": dict(plan=_nan_burst, ckpt=True, ckpt_every=2,
                      interval=15.0),
}


@functools.lru_cache(maxsize=None)
def _runs(name):
    j = pipe(False, **SCENARIOS[name])
    t = pipe(True, **SCENARIOS[name])
    assert_same_run(j, t)
    return j, t


def test_healthy_run_bit_identical_with_watchdog_and_guard():
    """Monitor on and guard armed, no faults: the rollouts, stamps and
    final parameters equal a run with both off, bit for bit."""
    _, on = _runs("healthy")
    off = pipe(True, monitor=False, guard=False, interval=15.0)
    assert on.p.monitor is not None and on.p.monitor.sweeps > 0
    assert off.p.monitor is None
    assert on.digest() == off.digest()
    h = on.p.monitor.stats()
    assert h["hangs_detected"] == 0 and h["stragglers_demoted"] == 0
    assert on.p.pool_stats()["trainer"]["bad_steps"] == 0


def test_hang_detected_and_healed():
    _, t = _runs("hang")
    p = t.p
    ps = p.pool_stats()
    h = ps["health"]
    assert h["hangs_detected"] >= 1
    assert all(lat > 0 for lat in h["hang_detect_latency"])
    kinds = [f["kind"] for f in ps["fault_log"]]
    assert {"engine_hang", "engine_hang_detected",
            "engine_restore"} <= set(kinds)
    assert p.actors[1].hangs == 1 and p.actors[1].recoveries >= 1
    assert ps["prompts_salvaged"] == (ps["prompts_requeued"]
                                      + ps["prompts_quarantined"])
    assert p.trainer.version >= 4


def test_declared_slow_engine_never_flagged():
    _, t = _runs("declared_slow")
    h = t.p.pool_stats()["health"]
    assert h["sweeps"] > 0
    assert h["hangs_detected"] == 0 and h["stragglers_demoted"] == 0
    assert t.p.router.health == [1.0, 1.0]


def test_straggler_demoted_and_restored():
    _, t = _runs("straggler")
    h = t.p.pool_stats()["health"]
    assert h["stragglers_demoted"] >= 1
    assert h["stragglers_restored"] >= 1
    assert h["hangs_detected"] == 0
    assert t.p.router.health == [1.0, 1.0]


def test_poison_prompt_quarantined():
    _, t = _runs("poison")
    p = t.p
    ps = p.pool_stats()
    assert ps["prompts_quarantined"] >= 1
    assert any(getattr(q, "_poison", False) for q in p.monitor.quarantined)
    assert ps["health"]["hangs_detected"] >= p.pc.health.quarantine_after
    assert ps["prompts_salvaged"] == (ps["prompts_requeued"]
                                      + ps["prompts_quarantined"])
    assert p.trainer.version >= 4


def test_corrupt_chunks_rejected_and_retransmitted():
    _, t = _runs("corrupt")
    bc = t.p.pool_stats()["broadcast"]
    assert bc["chunks_corrupt"] > 0
    # a damaged chunk still in flight when a newer publication supersedes
    # its stream, or when the run ends, is never offered to the gate
    assert 0 < bc["wchunks_rejected"] <= bc["chunks_corrupt"]
    assert bc["wstreams_torn"] == 0
    assert bc["retransmit_wait"] > 0
    assert t.p.trainer.version >= 4
    again = pipe(True, **SCENARIOS["corrupt"])
    assert again.digest() == t.digest()


def test_integrity_gate_blocks_torn_install():
    task = MathTask(max_operand=5, ops="+")
    _, cfg, _, params = weights()
    eng = GenerationEngine(cfg, params, EngineConfig(n_slots=2, max_len=16),
                           task.sample, seed=0, **CPU)
    sizes = eng.begin_weight_stream(params, version=7, n_chunks=4)
    good = [chunk_token(7, k, sizes[k]) for k in range(len(sizes))]
    assert eng.stream_weight_chunk(token=good[0] ^ 0x5AD0BAD) is False
    assert eng.wchunks_rejected == 1
    for k in range(len(sizes)):
        done = eng.stream_weight_chunk(token=good[k])
    assert done and eng.last_stream_installed and eng.version == 7
    sizes = eng.begin_weight_stream(params, version=8, n_chunks=4,
                                    expect_digest=stream_digest(good) ^ 1)
    for k in range(len(sizes)):
        done = eng.stream_weight_chunk(token=chunk_token(8, k, sizes[k]))
    assert done and not eng.last_stream_installed
    assert eng.wstreams_torn == 1 and eng.version == 7


# ---------------------------------------------------------------------------
# NaN-robust trainer: in-step guard, skip-and-count, rollback
# ---------------------------------------------------------------------------

def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    rolls = []
    for i in range(4):
        toks = rng.integers(0, cfg.vocab_size, size=10).astype(np.int32)
        rolls.append(Rollout(
            tokens=toks, prompt_len=3,
            behavior_logprobs=rng.normal(size=10).astype(np.float32) - 2.0,
            reward=float(rng.choice([-1.0, 1.0])),
            weight_versions=np.zeros(10, np.int32), prompt_key=i))
    b = pack(rolls, 2, 48)
    b.pop("packing_stats")
    return b


def test_guarded_step_bit_identical_when_healthy():
    _, cfg, _, params = weights()
    b = _batch(cfg, 1)
    tg = Trainer(cfg, params, guard=True, **CPU)
    tu = Trainer(cfg, params, guard=False, **CPU)
    tg.step(b)
    tu.step(b)
    assert not tg.last_nonfinite()
    assert leaves_equal(torch_leaves(tg.params), torch_leaves(tu.params))
    assert tg.version == tu.version == 1


def test_guard_drops_poisoned_step_bitwise():
    _, cfg, _, params = weights()
    tr = Trainer(cfg, params, guard=True, **CPU)
    tr.step(_batch(cfg, 1))
    before = torch_leaves(tr.state)
    tr.step(_batch(cfg, 2), poison=True)
    assert tr.last_nonfinite() and tr.nonfinite_steps == 1
    assert leaves_equal(torch_leaves(tr.state), before)
    assert tr.version == 1
    tr.step(_batch(cfg, 2))
    assert not tr.last_nonfinite() and tr.version == 2


def test_nan_burst_skipped_and_rolled_back():
    _, t = _runs("nan_burst")
    tr = t.p.pool_stats()["trainer"]
    assert tr["bad_steps"] >= 4 and tr["nonfinite_steps"] >= 4
    assert tr["rollbacks"] >= 1
    assert t.p.trainer.version >= 4


# ---------------------------------------------------------------------------
# checkpoint rotation + newest-intact fallback
# ---------------------------------------------------------------------------

def test_checkpoint_content_checksum_rejects_corruption(tmp_path):
    path = str(tmp_path / "ck.npz")
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    like = {"w": torch.zeros(8)}
    checkpoint.save(path, tree)
    assert checkpoint.verify(path)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) // 2])
    assert not checkpoint.verify(path)
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.load(path, like)
    checkpoint.save(path, tree)
    with np.load(path) as d:
        flat = dict(d)
    flat["w"] = flat["w"] + 1.0              # content changes, crc stale
    with zipfile.ZipFile(path, "w") as z:
        for k, v in flat.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(v))
            z.writestr(f"{k}.npy", buf.getvalue())
    assert not checkpoint.verify(path)
    with pytest.raises(checkpoint.CheckpointError, match="checksum"):
        checkpoint.load(path, like)


def test_rotation_keeps_k_and_falls_back_to_intact(tmp_path):
    _, cfg, _, params = weights()
    tr = Trainer(cfg, params, **CPU)
    ts = TrainerStage(EventLoop(), tr, queue=None, batch_size=0,
                      train_time=lambda n: 1.0, ckpt_dir=str(tmp_path),
                      ckpt_keep=2)
    for v in (1, 2, 3):
        ts._save_ckpt(v)
    rotated = sorted(f for f in os.listdir(tmp_path)
                     if f.startswith("trainer_step_"))
    assert rotated == ["trainer_step_000002.npz", "trainer_step_000003.npz"]
    assert os.path.exists(tmp_path / "trainer_latest.npz")
    for name in ("trainer_latest.npz", "trainer_step_000003.npz"):
        f = tmp_path / name
        f.write_bytes(f.read_bytes()[:100])
    used = ts.restore_newest_intact()
    assert used is not None and used.endswith("trainer_step_000002.npz")
    assert ts.ckpts_corrupt == 2
