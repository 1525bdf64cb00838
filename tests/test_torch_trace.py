"""The port's span recorder (`repro_torch.trace`) and the engine's counters,
on the CPU: the recorder off records nothing and reads no clock; on, spans
nest with their parents and fields; in a tiny paged engine with prefix
sharing the four children of each decode step tile it in order, the
prefill counters equal the arithmetic of the admitted prompts, the
blocking-transfer count equals the transfer sites the engine passed, one
rollout's id links its admission, its finish and its Preprocessor batch,
and recording changes nothing the engine computes."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import tiny
from repro_torch.core.preprocess import PreprocessConfig, Preprocessor
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.data.math_task import Problem
from repro_torch.models import model as TM

EC = EngineConfig(n_slots=8, max_len=16, prefill_chunk=4, cache="paged",
                  page_size=4, prefix_sharing=True, temperature=1.0,
                  eos_id=-1)
# three GRPO groups of four, run to max_len (no end id), so a group's copies
# finish together: P-1 = 5 splits a page of 4, so the forks copy a page at
# their divergence; the third group enters when the second finishes
PROMPTS = ([list(range(3, 9))] * 4 + [list(range(5, 14))] * 4
           + [list(range(4, 11))] * 4)
STEP_PARTS = ["engine.step.pages", "engine.step.enqueue", "engine.step.wait",
              "engine.step.finish"]


@pytest.fixture(autouse=True)
def recorder_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _engine(seed=3):
    torch.manual_seed(0)
    cfg = tiny.config(vocab_size=32, d_model=64)
    params = TM.init_params(cfg, seed=0, device="cpu")
    it = iter([Problem(list(p), 0) for p in PROMPTS])
    eng = GenerationEngine(cfg, params, EC, lambda: next(it, None),
                           seed=seed, device="cpu")
    return cfg, params, eng


def _drive(eng, on_refill=None, on_step=None, max_ticks=200):
    done = []
    for _ in range(max_ticks):
        before = eng._host_active.copy()
        eng.refill()
        if on_refill:
            on_refill(eng, before)
        got = eng.step()
        if on_step:
            on_step(eng, got)
        done += got
        if eng.n_active == 0 and len(done) == len(PROMPTS):
            break
    return done


class _NoClock:
    @staticmethod
    def perf_counter():
        raise AssertionError("the recorder read the clock while off")


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(trace, "time", _NoClock)
    sp = trace.span("a", x=1)
    assert sp is trace.OFF and trace.span("b") is trace.OFF and not sp
    with sp as inner:
        inner.set(y=2)
    assert trace.take() == []


def test_on_nests_with_parents_and_fields_and_take_resets():
    trace.enable()
    with trace.span("a", k=1) as a:
        assert a
        with trace.span("b"):
            pass
        with trace.span("c") as c:
            c.set(n=3)
            with trace.span("d"):
                pass
        a.set(m=2)
    with trace.span("e"):
        pass
    recs = trace.take()
    assert [r[0] for r in recs] == ["a", "b", "c", "d", "e"]
    assert [r[3] for r in recs] == [-1, 0, 0, 2, -1]
    assert recs[0][4] == {"k": 1, "m": 2} and recs[2][4] == {"n": 3}
    for name, t0, t1, parent, _ in recs:
        assert t0 <= t1
        if parent >= 0:
            assert recs[parent][1] <= t0 and t1 <= recs[parent][2]
    assert trace.take() == []
    # a span opened after take() inside one opened before it is a root
    with trace.span("old"):
        trace.take()
        with trace.span("new"):
            pass
    assert [(r[0], r[3]) for r in trace.take()] == [("new", -1)]
    trace.disable()
    with trace.span("z"):
        pass
    assert trace.take() == []


def test_threads_keep_their_own_parents():
    trace.enable()

    def work(tag):
        for _ in range(50):
            with trace.span("outer", tag=tag):
                with trace.span("inner", tag=tag):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    recs = trace.take()
    assert len(recs) == 4 * 50 * 2
    for name, _, _, parent, fields in recs:
        if name == "inner":
            assert recs[parent][0] == "outer"
            assert recs[parent][4]["tag"] == fields["tag"]
        else:
            assert parent == -1


def _children(recs, i):
    return [r for r in recs if r[3] == i]


def test_step_children_tile_the_step_in_order():
    _, _, eng = _engine()
    trace.enable()
    done = _drive(eng)
    recs = trace.take()
    assert len(done) == len(PROMPTS)
    steps = [i for i, r in enumerate(recs) if r[0] == "engine.step"]
    assert len(steps) > 10
    for i in steps:
        step = recs[i]
        kids = _children(recs, i)
        assert [k[0] for k in kids] == STEP_PARTS
        assert step[1] <= kids[0][1]
        for a, b in zip(kids, kids[1:]):
            assert a[2] <= b[1]
        assert kids[-1][2] <= step[2]
        # the parts hold the step's work: only a few statements fall
        # between them
        covered = sum(k[2] - k[1] for k in kids)
        assert covered >= 0.8 * (step[2] - step[1])
        assert step[4]["version"] == 0 and 0 < step[4]["rows"] <= EC.n_slots
    # a refill that admitted has its admission, its prefill and, with a
    # group, its forks as children
    refills = [i for i, r in enumerate(recs)
               if r[0] == "engine.refill" and r[4].get("admitted")]
    assert len(refills) == 2
    for i in refills:
        assert [k[0] for k in _children(recs, i)] == [
            "engine.refill.admit", "engine.refill.prefill",
            "engine.refill.fork"]


def test_prefill_counters_match_the_admitted_prompts():
    _, _, eng = _engine()
    want = {"useful": 0, "rows": 0, "refills": [], "batch": []}

    def on_refill(e, before):
        new = np.nonzero(e._host_active & ~before)[0]
        if not len(new):
            return
        leaders = {tuple(e.problems[s].prompt_ids) for s in new}
        lens = sorted(len(p) for p in leaders)
        chunks = -(-(max(lens) - 1) // EC.prefill_chunk)
        want["useful"] += sum(n - 1 for n in lens)
        # each chunk runs the rows the refill admitted, forks included
        want["rows"] += len(new) * EC.prefill_chunk * chunks
        want["batch"].append(len(new))
        want["refills"].append((lens, chunks))
        assert (e.prefill_tokens, e.prefill_row_tokens) == (
            want["useful"], want["rows"])

    trace.enable()
    _drive(eng, on_refill=on_refill)
    recs = trace.take()
    assert len(want["refills"]) == 2
    assert (eng.prefill_tokens, eng.prefill_row_tokens) == (
        (5 + 8) + 6, 4 * (8 * 2 + 4 * 2))
    got = [(sorted(r[4]["leaders"]), r[4]["chunks"]) for r in recs
           if r[0] == "engine.refill.prefill"]
    assert got == want["refills"]
    assert [r[4]["rows"] for r in recs
            if r[0] == "engine.refill.prefill"] == want["batch"] == [8, 4]


class _Sites:
    """Counts the calls that move data between host and device, made from
    the engine's own module: `torch.from_numpy` (each one is moved to the
    device at once), `torch.tensor(..., device=)` and `Tensor.cpu`."""

    MODULE = "repro_torch.core.rollout"

    def __init__(self, monkeypatch):
        self.n = 0
        from_numpy, tensor, cpu = torch.from_numpy, torch.tensor, \
            torch.Tensor.cpu

        def mine():
            return sys._getframe(2).f_globals.get("__name__") == self.MODULE

        def count_from_numpy(*a, **k):
            self.n += mine()
            return from_numpy(*a, **k)

        def count_tensor(*a, **k):
            self.n += mine() and "device" in k
            return tensor(*a, **k)

        def count_cpu(t, *a, **k):
            self.n += mine()
            return cpu(t, *a, **k)

        monkeypatch.setattr(torch, "from_numpy", count_from_numpy)
        monkeypatch.setattr(torch, "tensor", count_tensor)
        monkeypatch.setattr(torch.Tensor, "cpu", count_cpu)


def test_blocking_transfers_match_the_sites_passed(monkeypatch):
    _, _, eng = _engine()
    sites = _Sites(monkeypatch)
    seen = {"copies": 0, "finished": 0}
    n0 = eng.blocking_transfers

    def check(e, got=None):
        seen["finished"] += bool(got)
        assert e.blocking_transfers - n0 == sites.n

    trace.enable()
    _drive(eng, on_refill=lambda e, b: check(e), on_step=check)
    recs = trace.take()
    seen["copies"] = sum(bool(r[4].get("copies")) for r in recs
                         if r[0] == "engine.step.pages")
    # every site kind was passed: copy-on-write copies, finished rows
    assert seen["copies"] and seen["finished"] and sites.n > 0


def test_one_rollout_id_links_admission_finish_and_preprocessor():
    cfg, params, eng = _engine()
    pre = Preprocessor(cfg, params, PreprocessConfig(max_len=EC.max_len),
                       device="cpu")
    trace.enable()
    done = _drive(eng)
    pre.process(done[:5])
    pre.process(done[5:])
    recs = trace.take()
    rids = sorted(r.rid for r in done)
    assert rids == list(range(len(PROMPTS)))

    def holding(name, rid):
        return [r for r in recs
                if r[0] == name and rid in r[4].get("rids", ())]

    for r in done:
        assert len(holding("engine.refill.admit", r.rid)) == 1
        assert len(holding("engine.step.finish", r.rid)) == 1
        assert len(holding("pre.process", r.rid)) == 1
    pres = [i for i, r in enumerate(recs) if r[0] == "pre.process"]
    assert [recs[i][4]["tokens"] for i in pres] == [
        sum(r.length for r in done[:5]), sum(r.length for r in done[5:])]
    for i in pres:
        assert [k[0] for k in _children(recs, i)] == ["pre.ref_logprobs"]


COUNTERS = ("tokens_generated", "prefill_tokens", "prefill_row_tokens",
            "prefill_invocations", "blocking_transfers", "pages_copied",
            "prefix_forks", "next_rid")


def test_recording_changes_nothing_the_engine_computes():
    out = []
    for on in (False, True):
        _, _, eng = _engine()
        if on:
            trace.enable()
        done = sorted(_drive(eng), key=lambda r: r.rid)
        trace.disable()
        assert bool(trace.take()) == on
        out.append((done, {k: getattr(eng, k) for k in COUNTERS}))
    (a, ca), (b, cb) = out
    assert ca == cb
    assert [r.rid for r in a] == [r.rid for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        np.testing.assert_array_equal(x.behavior_logprobs,
                                      y.behavior_logprobs)
