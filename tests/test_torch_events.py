"""The port's orchestration substrate on the CPU: twins of `test_events.py`
(all but its fault and mesh-lowering tests, which wait for ROADMAP.md queue
A.7) and of `test_sim.py`.

The event loop, the sample queue, the chunk plan and the Appendix-A model
are held against the JAX package's on the same inputs: they must give the
same results exactly (they are the same arithmetic on the host). The
stage tests drive the port's `PipelineRL` at the tiny config (1 layer,
d 64, float32) and assert what the JAX package's tests assert.
"""
import copy
import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import events as jev  # noqa: E402
from repro.core import queues as jqueues  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.data.packing import Rollout as JaxRollout  # noqa: E402
from repro_torch.configs import tiny as port_tiny  # noqa: E402
from repro_torch.core import sim  # noqa: E402
from repro_torch.core.events import (EventLoop, chunk_spans,  # noqa: E402
                                     span_bytes, tree_bytes)
from repro_torch.core.pipeline import PipelineConfig, PipelineRL  # noqa: E402
from repro_torch.core.preprocess import (PreprocessConfig,  # noqa: E402
                                         Preprocessor)
from repro_torch.core.queues import SampleQueue  # noqa: E402
from repro_torch.core.rollout import EngineConfig, GenerationEngine  # noqa: E402
from repro_torch.core.sim import (HardwareModel,  # noqa: E402
                                  best_pipeline_config,
                                  conventional_throughput, fig9_curves,
                                  pipeline_throughput)
from repro_torch.data.math_task import MathTask  # noqa: E402
from repro_torch.data.packing import Rollout  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

CPU = {"device": "cpu"}
PC = dict(batch_size=4, n_chips=8, train_chips=4, pack_rows=2, pack_seq=48)


@pytest.fixture(scope="module")
def setup():
    task = MathTask(max_operand=5, ops="+")
    cfg = port_tiny.config(vocab_size=task.tok.vocab_size, d_model=64,
                           n_layers=1)
    return task, cfg, M.init_params(cfg, 0, **CPU)


def _pipeline(setup, pc, ec=None, **kw):
    task, cfg, params = setup
    return PipelineRL(cfg, params, task,
                      ec or EngineConfig(n_slots=4, max_len=20),
                      PipelineConfig(**pc), **CPU, **kw)


# ---------------------------------------------------------------------------
# event loop
# ---------------------------------------------------------------------------

def _loop_script(loop_cls):
    loop = loop_cls()
    fired = []
    loop.post(3.0, lambda t: fired.append(("c", t)))
    loop.post(1.0, lambda t: fired.append(("a", t)))
    loop.post(1.0, lambda t: fired.append(("b", t)))   # tie: FIFO
    loop.post(2.0, lambda t: loop.post(0.5, lambda u: fired.append(("d", u))))
    loop.run()
    return fired, loop.now, loop.events_processed


def test_event_loop_time_order_and_fifo_ties():
    fired, now, n = _loop_script(EventLoop)
    assert fired == [("a", 1.0), ("b", 1.0), ("d", 2.0), ("c", 3.0)]
    assert now == 3.0
    assert (fired, now, n) == _loop_script(jev.EventLoop)


def test_event_loop_clamps_past_and_resumes():
    loop = EventLoop()
    fired = []
    loop.post(5.0, lambda t: loop.post(1.0, lambda u: fired.append(u)))
    loop.run()
    assert fired == [5.0]   # posting into the past clamps to now
    loop.post(7.0, lambda t: fired.append(t))
    loop.run(until=lambda: len(fired) >= 1)
    assert fired == [5.0]   # pending events survive a bounded run
    loop.run()
    assert fired == [5.0, 7.0]


# ---------------------------------------------------------------------------
# chunk plan helpers
# ---------------------------------------------------------------------------

def test_chunk_spans_cover_and_balance():
    """The span table is the JAX package's on the same leaf sizes (torch
    tensors against numpy arrays), contiguous, complete and balanced."""
    import torch
    sizes = (7, 1, 9, 4, 4, 2, 30, 3)
    leaves = [torch.zeros(n) for n in sizes]
    jleaves = [np.zeros(n, np.float32) for n in sizes]
    for n_chunks in (1, 3, 8, 100):
        spans = chunk_spans(leaves, n_chunks)
        assert spans == jev.chunk_spans(jleaves, n_chunks)
        assert spans[0][0] == 0 and spans[-1][1] == len(leaves)
        for (a, b), (c, d) in zip(spans, spans[1:]):
            assert b == c and a < b
        assert len(spans) <= n_chunks
        assert sum(span_bytes(leaves, spans)) == tree_bytes(leaves)
        assert span_bytes(leaves, spans) == jev.span_bytes(jleaves, spans)


# ---------------------------------------------------------------------------
# streamed weight stream on the engine
# ---------------------------------------------------------------------------

def test_weight_stream_swaps_only_on_last_chunk(setup):
    task, cfg, params = setup
    params2 = M.init_params(cfg, 9, **CPU)
    eng = GenerationEngine(cfg, params, EngineConfig(n_slots=2, max_len=16),
                           task.sample, seed=0, **CPU)
    sizes = eng.begin_weight_stream(params2, version=5, n_chunks=4)
    assert len(sizes) >= 2 and sum(sizes) == tree_bytes(params2)
    for _ in range(len(sizes) - 1):
        assert eng.stream_weight_chunk() is False
        assert eng.version == 0            # old mu until the swap
        assert eng.params is params
    assert eng.stream_weight_chunk() is True
    assert eng.version == 5
    assert eng.params["embed"] is params2["embed"]   # pointer swap
    assert not eng.stream_active


def test_weight_stream_mid_sequence_versions_exact(setup):
    """Tokens sampled while the stream is in flight stamp the old version,
    tokens after the pointer swap the new one."""
    task, cfg, params = setup
    eng = GenerationEngine(cfg, params, EngineConfig(n_slots=2, max_len=32),
                           task.sample, seed=3, **CPU)
    eng.refill()
    for _ in range(5):
        eng.step(task)
    eng.begin_weight_stream(params, version=7, n_chunks=3)
    eng.step(task)
    eng.stream_weight_chunk()
    eng.step(task)
    while not eng.stream_weight_chunk():
        pass
    rollouts = []
    for _ in range(100):
        rollouts.extend(eng.step(task))
        if rollouts:
            break
    assert rollouts
    vers = rollouts[0].weight_versions[rollouts[0].prompt_len:]
    assert vers.min() == 0 and vers.max() == 7


def test_slow_broadcast_still_makes_progress(setup):
    """When the broadcast takes longer than the publish interval, the
    in-flight stream completes (the newest pending publication waits)."""
    p = _pipeline(setup, dict(PC, n_opt_steps=8, broadcast="streamed"),
                  hw=HardwareModel(bcast_bytes_per_flash=10.0))
    log = p.run()
    assert p.engine.version > 0
    assert p.broadcast_stats()["engines"][0]["streams_completed"] > 0
    assert all(np.isfinite(r["max_lag"]) for r in log)


def test_preprocess_overlaps_trainer(setup):
    """Fig. 4: the preprocessor starts a batch while the trainer is busy."""
    task, cfg, params = setup
    pre = Preprocessor(cfg, M.init_params(cfg, 7, **CPU),
                       PreprocessConfig(kl_coef=0.05, max_len=20, n_chips=1),
                       **CPU)
    p = _pipeline(setup, dict(PC, n_opt_steps=6),
                  ec=EngineConfig(n_slots=8, max_len=20),
                  hw=HardwareModel(tau=50.0), preprocessor=pre)
    intervals = {"pre": [], "train": []}
    orig_kick = p.pre_stage.kick

    def kick(now):
        busy0 = p.pre_stage.busy
        orig_kick(now)
        if not busy0 and p.pre_stage.busy:
            intervals["pre"].append((now, p.pre_stage.busy_until))
    p.pre_stage.kick = kick
    p.trainer_stage.on_free = kick
    orig_train = p.trainer_stage._train

    def train(rollouts, raw, avail, now, on_done):
        orig_train(rollouts, raw, avail, now, on_done)
        intervals["train"].append((max(now, avail), p.trainer_stage.free_at))
    p.trainer_stage._train = train
    p.run()
    assert any(a < d and c < b for a, b in intervals["pre"]
               for c, d in intervals["train"]), intervals


def test_atomic_set_weights_supersedes_stream(setup):
    task, cfg, params = setup
    params2 = M.init_params(cfg, 1, **CPU)
    eng = GenerationEngine(cfg, params, EngineConfig(n_slots=2, max_len=16),
                           task.sample, seed=0, **CPU)
    eng.begin_weight_stream(params2, version=3, n_chunks=4)
    eng.stream_weight_chunk()
    eng.set_weights(params2, version=9)
    assert not eng.stream_active and eng.version == 9
    assert eng.stream_weight_chunk() is False


# ---------------------------------------------------------------------------
# actor pool on the scheduler
# ---------------------------------------------------------------------------

def test_actor_pool_two_engines_runs_and_propagates(setup):
    p = _pipeline(setup, dict(PC, n_opt_steps=5, n_engines=2))
    log = p.run()
    assert [r["version"] for r in log] == [1, 2, 3, 4, 5]
    times = [r["time"] for r in log]
    assert times == sorted(times) and times[0] > 0
    assert all(e.tokens_generated > 0 for e in p.engines)
    assert all(e.version > 0 for e in p.engines)
    # pool engines hold the trainer's tensors, not copies
    assert p.engines[1].params["embed"] is p.engines[0].params["embed"]
    warm = log[2:]
    assert 0 < max(r["max_lag"] for r in warm) <= 10
    assert all(r["mean_lag"] <= r["max_lag"] for r in warm)


def test_actor_pool_staggered_arrivals(setup):
    """Sequential unicast: engine 1's publication lands after engine 0's."""
    p = _pipeline(setup, dict(PC, n_opt_steps=4, n_engines=2,
                              broadcast="streamed"),
                  hw=HardwareModel(bcast_bytes_per_flash=50.0))
    p.run()
    assert p.engines[1].version <= p.engines[0].version


def test_streamed_pause_below_atomic(setup):
    stats = {}
    for mode in ("streamed", "atomic", "free"):
        p = _pipeline(setup, dict(PC, n_opt_steps=4, broadcast=mode),
                      hw=HardwareModel(bcast_bytes_per_flash=2e3,
                                       bcast_install_flash=1.0))
        log = p.run()
        assert [r["time"] for r in log] == sorted(r["time"] for r in log)
        st_ = p.broadcast_stats()
        assert st_["mode"] == mode and st_["published"] >= 1
        stats[mode] = st_["engines"][0]
    assert stats["free"]["pause_total"] == 0.0
    assert stats["atomic"]["pause_per_update"] > 0
    assert stats["streamed"]["updates_applied"] > 0
    assert (stats["streamed"]["pause_per_update"]
            < stats["atomic"]["pause_per_update"])


# ---------------------------------------------------------------------------
# SampleQueue back-pressure and the trainer stall
# ---------------------------------------------------------------------------

def _mk(cls, i):
    return cls(tokens=np.zeros(4, np.int32), prompt_len=1,
               behavior_logprobs=np.zeros(4, np.float32), reward=float(i),
               weight_versions=np.zeros(4, np.int32), prompt_key=i)


def test_sample_queue_drop_oldest_counters():
    counters = []
    for qcls, rcls in ((SampleQueue, Rollout),
                       (jqueues.SampleQueue, JaxRollout)):
        q = qcls(maxsize=4)
        q.put([_mk(rcls, i) for i in range(10)])
        q.requeue_front([_mk(rcls, 99)])
        counters.append((len(q), q.total_put, q.dropped, q.requeued,
                         q.high_watermark,
                         [r.prompt_key for r in q.pop(4)]))
        with pytest.raises(ValueError):
            q.pop(1)
    assert counters[0] == counters[1] == (4, 10, 7, 1, 5, [6, 7, 8, 9])


def test_trainer_stall_backpressure_bounds_lag(setup):
    ec = EngineConfig(n_slots=8, max_len=20)

    def run(maxsize):
        p = _pipeline(setup, dict(PC, n_opt_steps=8, queue_maxsize=maxsize,
                                  ckpt_every=3, ckpt_pause=50_000.0), ec=ec)
        return p, p.run()

    p_b, log_b = run(8)
    p_u, log_u = run(None)
    assert p_b.trainer_stage.stalls >= 2
    assert p_b.queue.dropped > 0 and p_u.queue.dropped == 0
    assert p_b.queue.total_put > 0
    assert max(r["max_lag"] for r in log_b) <= max(r["max_lag"] for r in log_u)
    assert (max(r["queue_depth"] for r in log_u)
            >= max(r["queue_depth"] for r in log_b))


# ---------------------------------------------------------------------------
# overlapped preprocessor stage
# ---------------------------------------------------------------------------

def test_preprocessor_stage_overlaps_and_shapes(setup):
    task, cfg, params = setup
    pre = Preprocessor(cfg, M.init_params(cfg, 7, **CPU),
                       PreprocessConfig(kl_coef=0.05, max_len=20), **CPU)
    p = _pipeline(setup, dict(PC, n_opt_steps=4),
                  ec=EngineConfig(n_slots=8, max_len=20), preprocessor=pre)
    log = p.run()
    assert len(log) == 4
    assert p.pre_stage.batches >= 4
    assert all(np.isfinite(r["loss"]) for r in log)
    assert [r["time"] for r in log] == sorted(r["time"] for r in log)
    assert pre.stage_time(100) == pytest.approx(100 * 4.92 / 3.0 / 2)


def test_preprocessor_fused_ref_logprobs_parity(setup):
    task, cfg, params = setup
    ref_params = M.init_params(cfg, 7, **CPU)
    eng = GenerationEngine(cfg, params, EngineConfig(n_slots=4, max_len=16),
                           task.sample, seed=2, **CPU)
    eng.refill()
    rollouts = []
    for _ in range(40):
        rollouts.extend(eng.step(task))
        if eng.n_active == 0:
            break
    assert rollouts
    pcfg = PreprocessConfig(kl_coef=0.1, max_len=16)
    out_l = Preprocessor(cfg, ref_params, pcfg, **CPU).process(
        [copy.copy(r) for r in rollouts])
    out_f = Preprocessor(dataclasses.replace(cfg, fused_loss=True),
                         ref_params, pcfg, **CPU).process(
        [copy.copy(r) for r in rollouts])
    for a, b in zip(out_l, out_f):
        np.testing.assert_allclose(a.ref_logprobs, b.ref_logprobs,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.token_rewards, b.token_rewards,
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the Appendix-A model (twins of test_sim.py): the JAX package's numbers
# ---------------------------------------------------------------------------

HW, JHW = HardwareModel(), jsim.HardwareModel()


def test_sim_gives_the_reference_numbers_exactly():
    for args in ((128, 128, 134, 2048), (8, 16, 4, 64), (64, 32, 1, 512)):
        assert conventional_throughput(HW, *args) == \
            jsim.conventional_throughput(JHW, *args)
    for args in ((128, 128, 64, 256, 2048), (8, 16, 3, 12, 64)):
        assert pipeline_throughput(HW, *args) == \
            jsim.pipeline_throughput(JHW, *args)
    assert best_pipeline_config(HW, 128, 128, 2048, g_max_limit=133) == \
        jsim.best_pipeline_config(JHW, 128, 128, 2048, g_max_limit=133)
    assert fig9_curves(HW, g_grid=(2, 133, 256)) == \
        jsim.fig9_curves(JHW, g_grid=(2, 133, 256))
    hw = HardwareModel(speed=2.0, page_touch_flash=0.5).scaled(1.5)
    jhw = jsim.HardwareModel(speed=2.0, page_touch_flash=0.5).scaled(1.5)
    for h in (0, 1, 17, 256, 1000):
        assert hw.step_cost(h) == jhw.step_cost(h)
        assert float(hw.U(h)) == float(jhw.U(h))
    assert hw.prefill_time(100, 3) == jhw.prefill_time(100, 3)
    assert hw.page_touch_time(7) == jhw.page_touch_time(7)
    assert hw.broadcast_time(1e6) == jhw.broadcast_time(1e6)
    assert hw.train_time(1000, 4) == jhw.train_time(1000, 4)


def test_train_throughput_matches_paper():
    _, _, r_train = conventional_throughput(HW, 128, 128, 134, 2048)
    assert r_train == pytest.approx(26.02, rel=0.01)


def test_case_study_conventional():
    r_conv, r_gen, _ = conventional_throughput(HW, 128, 128, 134, 2048)
    assert r_conv == pytest.approx(10.7, rel=0.10)
    assert r_gen == pytest.approx(18.3, rel=0.10)


def test_case_study_pipeline():
    best = best_pipeline_config(HW, 128, 128, 2048, g_max_limit=133)
    assert best[0] == pytest.approx(16.9, rel=0.05)


def test_speedup_at_g133_close_to_paper():
    rows = {r["g_max"]: r for r in fig9_curves(HW, g_grid=(133,))}
    assert rows[133]["speedup"] == pytest.approx(1.57, rel=0.08)


@given(st.integers(2, 256))
@settings(max_examples=30, deadline=None)
def test_pipeline_never_slower_at_equal_lag(g):
    r_conv, _, _ = conventional_throughput(HW, 128, 128, max(g, 1), 2048)
    best = best_pipeline_config(HW, 128, 128, 2048, g_max_limit=g)
    if best is not None:
        assert best[0] >= r_conv * 0.98


@given(st.integers(1, 127), st.integers(1, 512))
@settings(max_examples=50, deadline=None)
def test_pipeline_throughput_is_min_of_stages(I, H):
    r, r_gen, r_train, g = pipeline_throughput(HW, 128, 128, I, H, 2048)
    assert r == pytest.approx(min(r_gen, r_train))
    assert g >= 1
    assert (r, r_gen, r_train, g) == jsim.pipeline_throughput(
        JHW, 128, 128, I, H, 2048)


def test_utilization_monotonic_saturating():
    assert sim.HardwareModel().U(0) == 0
    assert HW.U(128) < HW.U(256)
    assert HW.U(256) == HW.U(1024) == HW.u_max
