"""The readers of the program's own spans and counters (`rlbench/program.py`
and `rlbench/metrics/`) on canned records, the attribution of the card's
idle time to the innermost span by overlap, and a CPU rehearsal of a traced
rollout run with the program's recorder on (`program.run_driver`),
whose record holds the program's spans and counters."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from rlbench import harness, program, rehearse, trace_program
from rlbench.drivers import rollout

ROOT = Path(__file__).resolve().parent.parent
# the per-layer metrics of BENCHMARK.json read from the program's spans and
# counters or from the device trace
TRACED = [m["name"] for m in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["per_layer"]
    if m["source"] in ("program_span", "program_counter", "device_trace")]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "p_" + name.replace(".", "_"), ROOT / f"rlbench/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _step(spans, t, parts, copies=0):
    """Append a decode step opening at `t` whose four parts last `parts`
    (seconds, in order); returns its end."""
    i = len(spans)
    spans.append(["engine.step", t, t + sum(parts), -1, {"rows": 8}])
    for name, d in zip(program.STEP_PARTS, parts):
        spans.append((name, t, t + d, i,
                      {"copies": copies} if name.endswith("pages") else {}))
        t += d
    spans[i] = tuple(spans[i])
    return t


def canned():
    """Two decode steps in a traced window of [0, 1): parts of 0.1, 0.2,
    0.3, 0.1 s each; a refill with one prefill of one leader of 70 ids in
    chunks of 64 over 8 rows between them."""
    spans = []
    t = _step(spans, 0.0, (0.1, 0.2, 0.3, 0.1))
    spans += [("engine.refill", 0.7, 0.8, -1, {"admitted": 8}),
              ("engine.refill.prefill", 0.72, 0.8, len(spans),
               {"chunks": 2, "rows": 8, "leaders": [70]})]
    assert t == pytest.approx(0.7)
    _step(spans, 0.8, (0.02, 0.05, 0.1, 0.03), copies=1)
    # the card busy in the second half of each enqueue and over each wait
    busy = [(0.2, 0.6), (0.845, 0.95)]
    counters = [(-0.5, {"blocking_transfers": 10, "prefill_row_tokens": 0,
                        "prefill_tokens": 0}),
                (0.7, {"blocking_transfers": 12, "prefill_row_tokens": 0,
                       "prefill_tokens": 0}),
                (1.0, {"blocking_transfers": 21, "prefill_row_tokens": 1024,
                       "prefill_tokens": 69})]
    return {"program": {"spans": spans, "counters": counters, "busy": busy,
                        "kernel_starts": [0.2, 0.21, 0.845],
                        "t_lo": 0.0, "t_hi": 1.0}}


def test_step_host_ms_is_the_step_less_its_wait():
    got = reader("engine.step.host_ms")(canned())
    assert got == pytest.approx(1e3 * ((0.7 - 0.3) + (0.2 - 0.1)) / 2)


def test_idle_shares_by_innermost_span():
    rec = canned()
    # idle: [0, 0.2) pages 0.1 + enqueue 0.1; [0.6, 0.845): finish 0.1,
    # refill 0.02, prefill 0.08, pages 0.02, enqueue 0.025; [0.95, 1):
    # finish 0.03 and nothing open 0.02
    assert reader("device.idle.enqueue")(rec) == pytest.approx(
        100 * (0.1 + 0.025))
    assert reader("device.idle.step_host")(rec) == pytest.approx(
        100 * (0.1 + 0.1 + 0.02 + 0.03))


def test_idle_shares_need_the_clocks_aligned():
    rec = canned()
    p = rec["program"]
    assert program.wait_slacks(p) == [pytest.approx(0.0),
                                      pytest.approx(0.02)]
    assert program.aligned(p)
    # the card's activity drawn 0.1 ms late: its last activity ends after
    # the host's wait for it
    p["busy"] = [(a + 1e-4, b + 1e-4) for a, b in p["busy"]]
    assert not program.aligned(p)
    assert reader("device.idle.enqueue")(rec) is None
    # or 0.1 ms early: a first kernel before its launch
    p["busy"] = [(a - 1e-4, b - 1e-4) for a, b in canned()["program"]["busy"]]
    p["kernel_starts"] = [0.1 - 1e-4] + p["kernel_starts"]
    assert not program.aligned(p)
    assert reader("device.idle.step_host")(rec) is None


def test_prefill_share_and_transfers_per_step():
    rec = canned()
    assert reader("engine.prefill_useful_share")(rec) == pytest.approx(
        100 * 69 / 1024)
    # 11 transfers over the window's two steps
    assert reader("engine.blocking_transfers_per_step")(rec) == 5.5


def test_a_gap_straddling_two_spans_is_split_by_overlap():
    spans = [("a", 0.0, 1.0, -1, {}), ("b", 1.0, 2.0, -1, {}),
             ("b.in", 1.2, 1.5, 1, {})]
    # one gap from 0.9 to 1.3: 0.1 in a, 0.2 in b, 0.1 in b's child; a
    # mid-point rule would give it all to b
    idle = program.idle_by_span([(0.0, 0.9), (1.3, 3.0)], spans, 0.0, 3.0)
    assert idle == pytest.approx({"a": 0.1, "b": 0.2, "b.in": 0.1})
    pieces = program.innermost(spans, 0.5, 2.5)
    assert [p[2] for p in pieces] == ["a", "b", "b.in", "b", ""]
    assert sum(b - a for a, b, _ in pieces) == pytest.approx(2.0)


def test_kernel_lead_reads_steps_without_copies():
    p = canned()["program"]
    # first step: enqueue opens at 0.1, first kernel at 0.2 (no lead); the
    # second step made a copy and is not read
    assert program.kernel_leads(p) == [pytest.approx(0.1 - 0.2)]
    p["kernel_starts"] = [0.05] + p["kernel_starts"]
    assert program.kernel_leads(p) == [pytest.approx(0.05)]


def test_device_activity_maps_the_trace_through_its_anchors():
    # the trace's clock runs 100 ppm slow against the host's and 50 s
    # behind it; near the decode step's copy it has wandered 0.5 ms early;
    # the benchmark's own mark (by its start) is 400 us late
    acts = [("spin_kernel", 1.0, 1.000001), ("spin_kernel", 2.0, 2.000001),
            ("gemm", 3.0, 3.5), ("Memcpy DtoH (Device -> Pageable)", 3.6,
                                  3.7),
            ("gemm", 3.8, 4.0), ("spin_kernel", 12.0, 12.000001)]

    def line(d):
        return 50.0 + 1.0001 * d

    sync = line(3.7) + 5e-4
    clock = harness.Clock(t0=50.0)
    got = program.device_activity(
        acts, [line(2.000001), line(12.000001)], [sync, 70.0], clock, 2.5,
        3.9, t_mark=line(1.0) - 400e-6)
    assert got["drift_ppm"] == pytest.approx(100.0, rel=1e-6)
    assert got["mark_offset_us"] == pytest.approx(-400.0, rel=1e-6)
    # the marks and the one copy within reach of a sync (70.0 is far from
    # every copy) anchor the map
    assert got["anchors"] == 3
    assert got["wander_us"] == pytest.approx(500.0, rel=1e-6)

    def mapped(d):
        if d <= 3.7:
            w = 5e-4 * (d - 2.000001) / (3.7 - 2.000001)
        else:
            w = 5e-4 * (12.000001 - d) / (12.000001 - 3.7)
        return line(d) + w - 50.0

    assert mapped(3.7) == pytest.approx(sync - 50.0)
    want = [(mapped(3.0), mapped(3.5)), (mapped(3.6), mapped(3.7)),
            (mapped(3.8), 3.9)]
    assert got["busy"] == [pytest.approx(w, abs=1e-9) for w in want]
    assert got["kernel_starts"] == [pytest.approx(mapped(a), abs=1e-9)
                                    for a in (3.0, 3.8)]


def test_device_activity_follows_a_jump_of_the_trace_clock():
    """The trace's clock jumps 5 ms against the host's between two decode
    steps' reads: the walk from the first end mark pairs the reads before
    the jump, the walk back from the second those after it, and every
    kernel maps onto the host's clock as the reads around it place it (a
    line through the end marks puts the reads after the jump too far off
    to pair)."""
    copy = "Memcpy DtoH (Device -> Pageable)"
    acts = [("spin_kernel", 1.0, 1.000001), ("spin_kernel", 2.0, 2.000001)]
    acts += [(copy, d - 1e-4, d) for d in (3.0, 4.0, 5.0, 6.0)]
    acts += [("gemm", 3.5, 3.6), ("gemm", 5.5, 5.6),
             ("spin_kernel", 9.0, 9.000001)]

    def host(d):            # 40 us of wake-up after each end of work
        return d + 100.0 + (5e-3 if d > 4.5 else 0.0) + 40e-6

    got = program.device_activity(
        acts, [host(2.000001), host(9.000001)],
        [host(d) for d in (3.0, 4.0, 5.0, 6.0)], harness.Clock(t0=100.0),
        2.5, 8.0, t_mark=host(1.0))
    assert got["anchors"] == 6
    assert got["kernel_starts"] == [pytest.approx(host(a) - 100.0, abs=1e-9)
                                    for a in (3.5, 5.5)]
    busy = [(host(a) - 100.0, host(b) - 100.0) for a, b in
            [(3.5, 3.6), (5.5, 5.6)]]
    for b in busy:
        assert any(x == pytest.approx(b[0], abs=1e-9) and
                   y == pytest.approx(b[1], abs=1e-9) for x, y in got["busy"])


def test_one_misplaced_reading_among_many_fails_the_alignment():
    """The gate is strict: one step of twenty read outside `ALIGN_S` (as a
    jump of the trace's clock between two anchors would put it) leaves the
    idle shares out, since its idle time would go to the wrong span."""
    spans, busy, starts = [], [], []
    for i in range(20):
        t = 0.1 * i
        _step(spans, t, (0.01, 0.02, 0.03, 0.01))
        busy.append((t + 0.02, t + 0.06))
        starts.append(t + 0.02)
    p = {"spans": spans, "busy": busy, "kernel_starts": starts,
         "t_lo": 0.0, "t_hi": 2.0}
    assert len(program.kernel_leads(p)) + len(program.wait_slacks(p)) == 40
    assert program.aligned(p)
    late = lambda i: (busy[i][0] + 1e-4, busy[i][1] + 1e-4)  # noqa: E731
    p["busy"] = [late(i) if i == 7 else b for i, b in enumerate(busy)]
    assert not program.aligned(p)
    assert reader("device.idle.enqueue")({"program": p}) is None


def test_sync_points_are_the_reads_of_steps_that_finished_nothing():
    recs = [("engine.step", 0.0, 1.0, -1, {}),
            ("engine.step.wait", 0.5, 0.6, 0, {}),
            ("engine.step.finish", 0.6, 1.0, 0, {"rids": []}),
            ("engine.step", 1.0, 2.0, -1, {}),
            ("engine.step.wait", 1.5, 1.6, 3, {}),
            ("engine.step.finish", 1.6, 2.0, 3, {"rids": [7]})]
    assert program.sync_points(recs) == [0.6]


@pytest.mark.parametrize("name", TRACED)
def test_nothing_to_read_gives_none(name):
    assert reader(name)({}) is None
    rec = canned()
    rec["program"].update(spans=[], counters=[], busy=None)
    assert reader(name)(rec) is None


def test_rehearsed_rollout_records_the_programs_spans():
    torch.set_num_threads(2)
    c = rehearse.tiny_config(
        harness.load_config("rlbench/configs/granite-3-2b.json"))
    mix = harness.load_json("rlbench/traffic/rollout-grpo512.json")
    t = rehearse.tiny_rollout_traffic(mix)
    ctx = {"config": c, "traffic": t, "seed": 2 ** 31 + 7, "seconds": 0.5,
           "trace": True, "device": "cpu", "control": False,
           "clock": harness.Clock()}
    with rehearse.tiny_port(c):
        rec = program.run_driver(rollout, ctx, True)
    p = rec["program"]
    names = {s[0] for s in p["spans"]}
    assert {"engine.step", "engine.refill", "pre.process",
            "pre.ref_logprobs"} | set(program.STEP_PARTS) <= names
    steps = program.in_window(p, "engine.step")
    assert steps and all(set(program.children(p, i)) == set(
        program.STEP_PARTS) for i in steps)
    # one counter sample per decode step; the window's steps are the ones
    # its spans show
    d, n = program.counter_delta(p)
    assert n == len(steps)
    assert reader("engine.step.host_ms")(rec) > 0
    assert reader("engine.blocking_transfers_per_step")(rec) >= 1
    # the useful share equals the arithmetic of the window's leaders
    summary = trace_program.program_summary(rec)
    arith = summary["prefill_from_leaders"]
    assert arith["row_tokens"] > 0
    assert d["prefill_row_tokens"] == arith["row_tokens"]
    assert d["prefill_tokens"] == arith["useful"]
    assert reader("engine.prefill_useful_share")(rec) == pytest.approx(
        100 * arith["useful"] / arith["row_tokens"])
    # on the CPU there is no device trace: the idle shares read nothing
    assert reader("device.idle.enqueue")(rec) is None
    assert reader("device.idle.step_host")(rec) is None
    assert rec["checks"]["rollouts_unchecked"] == 0


def test_untraced_rehearsal_records_nothing_of_the_program():
    """`--trace 0` runs as before: the recorder off, no counter samples,
    no `program` entry."""
    from repro_torch import trace
    torch.set_num_threads(2)
    c = rehearse.tiny_config(
        harness.load_config("rlbench/configs/granite-3-2b.json"))
    t = rehearse.tiny_rollout_traffic(
        harness.load_json("rlbench/traffic/rollout-grpo512.json"))
    ctx = {"config": c, "traffic": t, "seed": 2 ** 31 + 9, "seconds": 0.3,
           "trace": False, "device": "cpu", "control": False,
           "clock": harness.Clock()}
    trace.take()
    with rehearse.tiny_port(c):
        rec = program.run_driver(rollout, ctx, False)
    assert "program" not in rec and trace.take() == []
    assert rec["spans"] == [] and rec["decode"] == []
