"""The port's request Server on the CPU: twins of `test_serving.py`, the
Server cases of `test_lag.py`, `test_scheduler.py`, `test_gray.py` and
`test_faults.py`, and `GenerationEngine.kill_slot`.

Every Server scenario runs in both packages from the same converted
weights and prompts at temperature 1e-4, on the slot cache and the paged
cache: `metrics()` must be equal as a whole, and every request's
completion ids and version stamps equal token for token.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.preprocess import PreprocessConfig as JaxPreprocessConfig
from repro.core.preprocess import Preprocessor as JaxPreprocessor
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.core.rollout import GenerationEngine as JaxEngine
from repro.core.serving import Server as JaxServer
from repro_torch import (EngineConfig, GenerationEngine, PipelineConfig,
                         PipelineRL, PreprocessConfig, Preprocessor, Request,
                         Server)
from torch_twin import CPU, GREEDY, one_thread, tasks, weights

CACHES = ["slots", "paged"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _ec(cache, **kw):
    kw = dict(dict(n_slots=4, max_len=16, temperature=GREEDY, cache=cache,
                   page_size=4), **kw)
    return JaxEngineConfig(**kw), EngineConfig(**kw,
                                               paged_attention="kernel")


def _servers(cache, ec=None, **kw):
    """(JAX Server, port Server) on the same weights."""
    jcfg, tcfg, jp, tp = weights()
    jec, tec = _ec(cache, **(ec or {}))
    return (JaxServer(jcfg, jp, jec, **kw),
            Server(tcfg, tp, tec, **kw, **CPU))


def _same(js, ts):
    """Equal metrics and equal per-request outcomes."""
    assert ts.metrics() == js.metrics()
    for name in ("done", "rejected", "shed", "quarantined"):
        a, b = getattr(js, name), getattr(ts, name)
        assert [r.rid for r in b] == [r.rid for r in a], name
        for x, y in zip(a, b):
            assert (y.submitted_at, y.admitted_at, y.finished_at,
                    y.retries) == (x.submitted_at, x.admitted_at,
                                   x.finished_at, x.retries)
            for k in ("completion_ids", "weight_versions"):
                u, v = getattr(x, k), getattr(y, k)
                assert (u is None) == (v is None), k
                if u is not None:
                    np.testing.assert_array_equal(np.asarray(v),
                                                  np.asarray(u))


def _drive(srv, prompts, until, updates=(), max_steps=200):
    for p in prompts:
        srv.submit(p)
    for i in range(max_steps):
        for at, fn in updates:
            if i == at:
                fn(srv)
        srv.step()
        if until(srv):
            break
    return srv


def _prompts(n, **kw):
    jtask, _ = tasks(**kw)
    return [jtask.sample().prompt_ids for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _second_weights():
    return weights(9)


def _connect_second(srv, version):
    _, _, jp2, tp2 = _second_weights()
    srv.connect_trainer(lambda: ((jp2 if isinstance(srv, JaxServer)
                                  else tp2), version))


@functools.lru_cache(maxsize=None)
def _scenario(name, cache):
    """Both packages' servers after one scripted scenario."""
    if name == "completes":
        prompts, until = _prompts(10), lambda s: len(s.done) == 10
        updates = ()
    elif name in ("inflight", "lag"):
        prompts, until = _prompts(8), lambda s: len(s.done) == 8
        updates = ((5, lambda s: s.request_weight_update()),)
    elif name == "streamed":
        prompts, until = _prompts(8), lambda s: len(s.done) == 8
        updates = ((1, lambda s: s.request_weight_update(streamed=True,
                                                         n_chunks=3)),)
    elif name == "no_updates":
        prompts, until = _prompts(4), lambda s: len(s.done) == 4
        updates = ()
    out = []
    for srv in _servers(cache):
        if name in ("inflight", "lag", "streamed"):
            _connect_second(srv, 4 if name == "streamed" else 3)
        out.append(_drive(srv, prompts, until, updates))
    _same(*out)
    return tuple(out)


@pytest.mark.parametrize("cache", CACHES)
def test_server_completes_all_requests(cache):
    _, srv = _scenario("completes", cache)
    m = srv.metrics()
    assert m["served"] == 10
    assert m["waiting"] == 0 and m["in_flight"] == 0
    assert sorted(r.rid for r in srv.done) == list(range(10))
    assert m["p99_latency"] >= m["p50_latency"] > 0
    assert m["mean_admission_wait"] > 0
    assert all(isinstance(r, Request) for r in srv.done)


@pytest.mark.parametrize("cache", CACHES)
def test_server_inflight_update_drops_nothing(cache):
    _, srv = _scenario("inflight", cache)
    assert len(srv.done) == 8
    assert any(r.weight_versions is not None and r.weight_versions.max() == 3
               for r in srv.done)


def test_server_idle_steps_safe():
    for srv in _servers("slots", ec=dict(n_slots=2, max_len=8)):
        for _ in range(3):
            assert srv.step() == []
        assert srv.metrics()["served"] == 0
        assert srv.clock == pytest.approx(3.0)


@pytest.mark.parametrize("cache", CACHES)
def test_server_streamed_update_installs_across_steps(cache):
    """One chunk per step; the version flips only at the pointer swap."""
    js, ts = _servers(cache)
    for srv in (js, ts):
        _connect_second(srv, 4)
        for p in _prompts(8):
            srv.submit(p)
        srv.step()
        assert srv.request_weight_update(streamed=True, n_chunks=3) == 4
        assert srv.engine.version == 0
        for _ in range(200):
            srv.step()
            if len(srv.done) == 8:
                break
        assert srv.engine.version == 4
        assert srv.metrics()["streams_completed"] == 1
        assert len(srv.done) == 8
        assert any(r.weight_versions.max() == 4 for r in srv.done)
    _same(js, ts)


# ---------------------------------------------------------------------------
# preprocessor stage
# ---------------------------------------------------------------------------

def _greedy_rollouts(seed):
    """The same greedy rollouts from both packages' engines."""
    jcfg, tcfg, jp, tp = weights()
    jtask, ttask = tasks()
    kw = dict(n_slots=4, max_len=16, temperature=GREEDY)
    outs = []
    for eng, task in ((JaxEngine(jcfg, jp, JaxEngineConfig(**kw),
                                 jtask.sample, seed=seed), jtask),
                      (GenerationEngine(tcfg, tp, EngineConfig(**kw),
                                        ttask.sample, seed=seed, **CPU),
                       ttask)):
        eng.refill()
        rollouts = []
        for _ in range(40):
            rollouts.extend(eng.step(task))
            if eng.n_active == 0:
                break
        outs.append(rollouts)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    return outs


def test_preprocessor_ref_logprobs_and_kl_penalty():
    jcfg, tcfg, _, _ = weights()
    _, _, jref, tref = weights(7)
    jr, tr = _greedy_rollouts(2)
    jout = JaxPreprocessor(jcfg, jref, JaxPreprocessConfig(
        kl_coef=0.1, max_len=16)).process(jr)
    out = Preprocessor(tcfg, tref, PreprocessConfig(kl_coef=0.1, max_len=16),
                       **CPU).process(tr)
    for r, j in zip(out, jout):
        L = len(r.token_rewards)
        assert (r.token_rewards[:r.prompt_len] == 0).all()
        mask = np.arange(L) >= r.prompt_len
        kl = float(((r.behavior_logprobs[:L] - r.ref_logprobs) * mask).sum())
        np.testing.assert_allclose(r.token_rewards.sum(),
                                   r.reward - 0.1 * kl, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r.ref_logprobs, j.ref_logprobs,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r.token_rewards, j.token_rewards,
                                   rtol=1e-5, atol=1e-6)


def test_preprocessor_self_reference_zero_kl():
    """pi_ref == mu: the logprobs recorded at sampling (temperature 1)
    match a fresh forward under the same weights."""
    _, tcfg, _, tp = weights()
    _, task = tasks()
    eng = GenerationEngine(tcfg, tp, EngineConfig(n_slots=4, max_len=16),
                           task.sample, seed=3, **CPU)
    eng.refill()
    tr = []
    for _ in range(40):
        tr.extend(eng.step(task))
        if eng.n_active == 0:
            break
    out = Preprocessor(tcfg, tp, PreprocessConfig(kl_coef=1.0, max_len=16),
                       **CPU).process(tr)
    for r in out:
        L = len(r.ref_logprobs)
        mask = np.arange(L) >= r.prompt_len
        assert np.abs((r.behavior_logprobs[:L] - r.ref_logprobs)
                      * mask).max() < 1e-3


def test_pipeline_with_preprocessor_stage():
    _, tcfg, _, tp = weights()
    _, _, _, tref = weights(7)
    _, task = tasks()
    pre = Preprocessor(tcfg, tref, PreprocessConfig(kl_coef=0.05, max_len=16),
                       **CPU)
    p = PipelineRL(tcfg, tp, task, EngineConfig(n_slots=8, max_len=16),
                   PipelineConfig(batch_size=4, n_opt_steps=3, n_chips=8,
                                  train_chips=4, pack_rows=2, pack_seq=48),
                   preprocessor=pre, **CPU)
    log = p.run()
    assert len(log) == 3
    assert all(np.isfinite(r["loss"]) for r in log)


# ---------------------------------------------------------------------------
# per-request weight lag (test_lag.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", CACHES)
def test_server_request_lag_metrics(cache):
    _, srv = _scenario("lag", cache)
    m = srv.metrics()
    assert m["requests_mixed_version"] >= 1
    assert m["request_lag_max"] >= 1.0
    assert 0.0 < m["request_lag_mean"] <= m["request_lag_max"]
    maxes = [float((r.weight_versions.max() - r.weight_versions).max())
             for r in srv.done if len(r.weight_versions)]
    assert m["request_lag_max"] == max(maxes)


def test_server_request_lag_zero_without_updates():
    _, srv = _scenario("no_updates", "slots")
    m = srv.metrics()
    assert m["request_lag_mean"] == m["request_lag_max"] == 0.0
    assert m["requests_mixed_version"] == 0


# ---------------------------------------------------------------------------
# admission policy and long prompts (test_scheduler.py)
# ---------------------------------------------------------------------------

def test_server_rejects_long_request():
    js, ts = _servers("slots", ec=dict(n_slots=2, max_len=8))
    prompt = _prompts(1)[0]
    for srv in (js, ts):
        rid_long = srv.submit([1] + [3] * 12)
        rid_ok = srv.submit(prompt)
        for _ in range(100):
            srv.step()
            if len(srv.done) == 1:
                break
        m = srv.metrics()
        assert m["prompts_rejected"] == 1 and m["prompts_truncated"] == 0
        assert [r.rid for r in srv.rejected] == [rid_long]
        assert srv.rejected[0].rejected
        assert srv.rejected[0].finished_at is not None
        assert m["served"] == 1 and srv.done[0].rid == rid_ok
        assert m["in_flight"] == 0 and m["waiting"] == 0
    _same(js, ts)


def test_server_sjf_admission_prefers_short_prompts():
    js, ts = _servers("slots", ec=dict(n_slots=1, max_len=16),
                      admission="sjf")
    for srv in (js, ts):
        rid_long = srv.submit([1] + [3] * 8)
        rid_short = srv.submit([1, 3, 4])
        srv.step()
        assert list(srv.in_flight) == [rid_short]
        assert [r.rid for r in srv.waiting] == [rid_long]
    with pytest.raises(ValueError):
        Server(weights()[1], weights()[3], EngineConfig(), admission="lifo",
               **CPU)


# ---------------------------------------------------------------------------
# graceful degradation (test_faults.py) and quarantine (test_gray.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", CACHES)
def test_server_deadline_retry_shed_accounting(cache):
    js, ts = _servers(cache, deadline=24.0, max_retries=2,
                      retry_backoff=4.0, queue_limit=16)
    prompts = _prompts(24)
    for srv in (js, ts):
        _, _, jp, tp = weights()
        own = jp if srv is js else tp
        srv.connect_trainer(lambda srv=srv, own=own: (own, srv._updates + 1))
        for p in prompts:
            srv.submit(p)
        assert srv.metrics()["requests_shed"] == 8
        steps = 0
        while (srv.waiting or srv.in_flight or srv._backoff) and steps < 600:
            srv.step()
            steps += 1
            if steps % 16 == 0:
                srv.request_weight_update(streamed=True)
        m = srv.metrics()
        assert m["requests_lost"] == 0
        assert m["requests_shed"] > 0
        assert m["deadline_misses"] > 0 and m["requests_retried"] > 0
        assert (m["served"] + m["requests_rejected"] + m["requests_shed"]
                == 24)
        assert m["retry_p99_latency"] >= m["retry_p50_latency"] >= 0.0
        for r in srv.done:
            if r.retries:
                assert r.latency > r.finished_at - r.submitted_at
    _same(js, ts)


def test_server_no_deadline_is_unchanged():
    js, ts = _servers("slots")
    for srv in (js, ts):
        for p in _prompts(8):
            srv.submit(p)
        steps = 0
        while (srv.waiting or srv.in_flight) and steps < 400:
            srv.step()
            steps += 1
        m = srv.metrics()
        assert m["served"] == 8 and m["requests_lost"] == 0
        assert m["deadline_misses"] == m["requests_retried"] == 0
        assert m["requests_shed"] == 0
    _same(js, ts)


@pytest.mark.parametrize("cache", CACHES)
def test_server_quarantine_accounting(cache):
    """One in-flight and one waiting request quarantined: the slot is
    reclaimed by `kill_slot` at once (paged: its pages too), the terminal
    state is counted and nothing is lost."""
    js, ts = _servers(cache, ec=dict(n_slots=2))
    prompts = _prompts(4)
    for srv in (js, ts):
        for p in prompts:
            srv.submit(p)
        for _ in range(3):
            srv.step()
        in_flight = next(iter(srv.in_flight))
        waiting = srv.waiting[0].rid
        assert srv.quarantine(in_flight, reason="poison")
        assert srv.engine.problems.count(None) >= 1
        if cache == "paged":
            srv.engine.tables.check()
        assert srv.quarantine(waiting, reason="repeat-offender")
        assert not srv.quarantine(9999)
        for _ in range(60):
            if not (srv.waiting or srv.in_flight):
                break
            srv.step()
        m = srv.metrics()
        assert m["requests_quarantined"] == 2 and m["requests_lost"] == 0
        assert all(r.quarantined and r.rejected and r.fail_reason
                   for r in srv.quarantined)
        if cache == "paged":
            assert srv.engine.allocator.live_pages == 0
    _same(js, ts)


@pytest.mark.parametrize("cache", CACHES)
def test_paged_admission_defers_on_pages_into_deadline_misses(cache):
    """A pool too small for every slot leaves candidates waiting on pages
    (`admissions_deferred`); their deadlines turn the pressure into counted
    misses and retries, never a hang."""
    js, ts = _servers(cache, ec=dict(n_slots=4, n_pages=5 if cache ==
                                     "paged" else 0),
                      admission="sjf", deadline=6.0, max_retries=1)
    prompts = _prompts(12)
    for srv in (js, ts):
        for p in prompts:
            srv.submit(p)
        steps = 0
        while (srv.waiting or srv.in_flight or srv._backoff) and steps < 400:
            srv.step()
            steps += 1
        m = srv.metrics()
        assert steps < 400 and m["requests_lost"] == 0
        assert m["deadline_misses"] > 0
        if cache == "paged":
            assert m["admissions_deferred"] > 0
            assert srv.engine.allocator.live_pages == 0
    _same(js, ts)


# ---------------------------------------------------------------------------
# GenerationEngine.kill_slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", CACHES)
def test_kill_slot_matches_jax(cache):
    """Killing one live slot hands its prompt back, writes the slot's
    device state as the JAX engine does, returns its pages (paged), leaves
    the other slots decoding on, and refills the slot."""
    jcfg, tcfg, jp, tp = weights()
    jtask, ttask = tasks()
    jec, tec = _ec(cache)
    je = JaxEngine(jcfg, jp, jec, jtask.sample, seed=0)
    te = GenerationEngine(tcfg, tp, tec, ttask.sample, seed=0, **CPU)
    outs = []
    for eng, task in ((je, jtask), (te, ttask)):
        eng.refill()
        for _ in range(3):
            eng.step(task)
        prob = eng.kill_slot(1)
        assert prob is not None and eng.problems[1] is None
        assert eng.kill_slot(1) is None
        if cache == "paged":
            eng.tables.check()
            assert not eng.tables.table[1].any()
        st = {k: np.asarray(eng.state[k]) for k in
              ("n_cached", "prompt_len", "active")}
        done = []
        eng.refill()
        for _ in range(20):
            done.extend(eng.step(task))
        outs.append((prob.prompt_ids, st, eng._host_active.copy(),
                     sorted((r.slot, r.tokens.tobytes()) for r in done)))
    (jp_, jst, ja, jd), (tp_, tst, ta, td) = outs
    assert tp_ == jp_
    for k in jst:
        np.testing.assert_array_equal(tst[k], jst[k])
    np.testing.assert_array_equal(ta, ja)
    assert td == jd
