"""The program's own spans and counters, read onto the window's clock.

The port records host spans where the work happens (`repro_torch.trace`,
on only when asked) and keeps counters as plain attributes of its engine
(`GenerationEngine.blocking_transfers`, `prefill_row_tokens`,
`prefill_tokens`). This module lays both onto the window's clock, beside
the device's busy intervals from a profiler trace (mapped onto the host's
clock through marks and the decode steps' own reads of the card,
`device_activity`, then `Clock.window_of`), and attributes each idle
interval of the card to the innermost program span open over it, by
overlap.

A record's `program` entry, which the readers of the program's metrics
take: {"spans": [(name, start, end, parent, fields)] on the window clock,
"counters": [(time, {counter: value})] sampled after every decode step,
"busy": [(start, end)] or None, "kernel_starts": [start] or None (kernels
alone, no copies), "t_lo", "t_hi": the traced window, and the map's
figures from `device_activity`}. `run_driver` puts it in the record of
every traced run (`run.py --trace 1`, `trace_program.py`). Without the
recorder (a program that lacks it, or a run that did not turn it on) a
reader finds nothing and returns None.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rlbench import harness

COUNTERS = ("blocking_transfers", "prefill_row_tokens", "prefill_tokens")
STEP_PARTS = ("engine.step.pages", "engine.step.enqueue", "engine.step.wait",
              "engine.step.finish")


def counters(eng) -> Optional[Dict[str, int]]:
    """The engine's counters now; None for a program without them."""
    if not all(hasattr(eng, k) for k in COUNTERS):
        return None
    return {k: int(getattr(eng, k)) for k in COUNTERS}


class Recording:
    """The port's recorder over one run of a driver: on from the start,
    with the engine's counters sampled after every decode step that the
    driver's traced wrapper times (`harness.Spans.wrap_decode`)."""

    def __init__(self):
        from repro_torch import trace
        self.trace = trace
        self.samples: List[Tuple[float, Dict[str, int]]] = []
        self.records: List[Tuple] = []
        trace.take()
        trace.enable()

    def sample(self, eng) -> None:
        c = counters(eng)
        if c is not None:
            self.samples.append((time.perf_counter(), c))

    def stop(self) -> None:
        self.trace.disable()
        self.records = self.trace.take()

    def program(self, rec: Dict, clock: harness.Clock) -> Dict:
        """The record's `program` entry (module docstring), with the
        device's activity of a profiled window (`harness.Profile`) mapped
        onto the window's clock."""
        t_hi = rec.get("t_prof_end") or rec["t_close"]
        p = {"spans": on_window(self.records, clock),
             "counters": [(clock.window_of(t), c) for t, c in self.samples],
             "busy": None, "kernel_starts": None, "t_lo": rec["t_open"],
             "t_hi": t_hi}
        prof = rec.get("traced")
        if prof:
            p.update(device_activity(
                prof["acts"], prof["ends"], sync_points(self.records), clock,
                p["t_lo"], t_hi, prof["t_mark"]))
        return p


def run_driver(driver, ctx: Dict, recorder: bool) -> Dict:
    """`driver.run(ctx)`; with `recorder`, under a `Recording` (the
    driver finds it as `ctx["recording"]`), and the record gains
    `program`."""
    if not recorder:
        return driver.run(ctx)
    recording = Recording()
    try:
        rec = driver.run(dict(ctx, recording=recording))
    finally:
        recording.stop()
    rec["program"] = recording.program(rec, ctx["clock"])
    return rec


def on_window(records, clock: harness.Clock) -> List[Tuple]:
    """The recorder's records with start and end on the window clock."""
    return [(n, clock.window_of(a), clock.window_of(b), p, f)
            for n, a, b, p, f in records]


SYNC_TOL = 2e-3   # how much earlier than its return a read's copy may map
TRACK_TOL = 5e-4  # how much later: the offset moves little from one read on


def sync_points(records) -> List[float]:
    """Host times (the recorder's clock) at which a decode step's read of
    its `finished` mask returned, for the steps that finished no row: their
    read is the only device-to-host copy within milliseconds."""
    out = []
    for i, (name, _, _, parent, fields) in enumerate(records):
        if name == "engine.step.finish" and fields.get("rids") == []:
            out += [r[2] for r in records
                    if r[3] == parent and r[0] == "engine.step.wait"]
    return out


def _track(copies: Sequence[float], syncs: Sequence[float],
           off: float) -> Dict[float, int]:
    """Each host return in `syncs`, walked in the order given, paired with
    the device-to-host copy (index into `copies`, their ends on the trace's
    clock) that the clocks' offset `off` (host less trace) puts last before
    it, within `TRACK_TOL` after and `SYNC_TOL` before; each pairing moves
    the offset to its own."""
    out = {}
    for h in syncs:
        j = bisect.bisect_right(copies, h - off + TRACK_TOL) - 1
        if j >= 0 and h - (copies[j] + off) <= SYNC_TOL:
            out[h] = j
            off = h - copies[j]
    return out


def device_activity(acts, ends: Sequence[float], syncs: Sequence[float],
                    clock: harness.Clock, t_lo: float, t_hi: float,
                    t_mark: float) -> Dict:
    """The busy intervals of the card in [t_lo, t_hi) and the start of
    every kernel there (copies, fills and marks left out), on the window
    clock. `acts`: (name, start, end) of each device activity on the
    trace's clock (`harness._kernels`). The trace's clock is mapped onto
    the host's piecewise linearly through anchors, each the end of the
    card's last work paired with the host's return from waiting for it:
    the last two mark kernels (`harness.end_mark`, host times `ends`), and
    each host return in `syncs` between them with its device-to-host copy
    (`_track`), found by walking the returns forward from the first mark
    and backward from the second, each step from the offset of the read
    before: the trace's clock can jump against the host's within a window
    (by 2.3 ms once on the card, then running 570 ppm fast), which a line
    through the marks spreads over the window and one walk does not cross.
    A return that the two walks pair with different copies is left out.
    `mark_offset_us`: where `harness.Profile`'s start mark (host time
    `t_mark` at its start) puts the kernels against the line through the
    end marks, negative when earlier; `wander_us`: the largest distance of
    an anchor from that line."""
    marks = sorted((a, b) for n, a, b in acts
                   if any(k in n for k in harness.MARK_KERNELS))
    (d0, d1), (h0, h1) = [b for _, b in marks[-2:]], ends
    rate = (h1 - h0) / (d1 - d0)
    copies = sorted(b for n, _, b in acts if n.startswith("Memcpy DtoH"))
    syncs = sorted(h for h in syncs if h0 < h < h1)
    walks = (_track(copies, syncs, h0 - d0),
             _track(copies, syncs[::-1], h1 - d1))
    anchors = {d0: h0, d1: h1}
    for h in syncs:
        found = {w[h] for w in walks if h in w}
        if len(found) == 1:
            anchors.setdefault(copies[found.pop()], h)
    dev = np.array(sorted(anchors))
    host = np.array([anchors[d] for d in dev])
    wander = np.abs(host - (h0 + (dev - d0) * rate)).max()
    acts = [x for x in acts
            if not any(k in x[0] for k in harness.MARK_KERNELS)]
    a_host = np.interp([a for _, a, _ in acts], dev, host)
    b_host = np.interp([b for _, _, b in acts], dev, host)
    busy, starts = [], []
    for (name, _, _), a, b in zip(acts, a_host, b_host):
        a, b = clock.window_of(float(a)), clock.window_of(float(b))
        if min(b, t_hi) > max(a, t_lo):
            busy.append((max(a, t_lo), min(b, t_hi)))
        if t_lo <= a < t_hi and not name.startswith(("Memcpy", "Memset")):
            starts.append(a)
    return {"busy": harness._union(busy), "kernel_starts": sorted(starts),
            "anchors": len(anchors), "wander_us": 1e6 * float(wander),
            "drift_ppm": 1e6 * (rate - 1.0),
            "mark_offset_us": 1e6 * (t_mark - (h0 + (marks[0][0] - d0)
                                               * rate))}


def in_window(p: Dict, name: str) -> List[int]:
    """Indices of the spans called `name` that lie inside the traced
    window."""
    return [i for i, s in enumerate(p["spans"]) if s[0] == name
            and p["t_lo"] <= s[1] and s[2] <= p["t_hi"]]


def children(p: Dict, i: int) -> Dict[str, Tuple]:
    return {s[0]: s for s in p["spans"] if s[3] == i}


def innermost(spans: Sequence[Tuple], lo: float,
              hi: float) -> List[Tuple[float, float, str]]:
    """[lo, hi) cut into pieces, each named by the innermost span open over
    it ("" where none is). Spans nest (one thread) and come in the order
    they opened."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[str, float]] = []
    t = lo

    def emit(a, b, name):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b, name))

    for name, a, b, *_ in sorted(spans, key=lambda s: s[1]):
        if a >= hi:
            break
        while stack and stack[-1][1] <= a:
            top, end = stack.pop()
            emit(t, end, top)
            t = max(t, end)
        emit(t, a, stack[-1][0] if stack else "")
        t = max(t, a)
        stack.append((name, b))
    while stack:
        top, end = stack.pop()
        emit(t, end, top)
        t = max(t, end)
    emit(t, hi, "")
    return out


def idle_by_span(busy: Sequence[Tuple[float, float]], spans: Sequence[Tuple],
                 lo: float, hi: float) -> Dict[str, float]:
    """Seconds of [lo, hi) in which the card ran nothing, by the innermost
    span open over them: a gap that straddles two spans is split between
    them by overlap."""
    gaps, prev = [], lo
    for a, b in list(busy) + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, min(a, hi)))
        prev = max(prev, b)
    out: Dict[str, float] = {}
    pieces = innermost(spans, lo, hi)
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, name = pieces[k]
            d = min(b, g1) - max(a, g0)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out


def idle_share(rec: Dict, names: Sequence[str]) -> Optional[float]:
    """Share (%) of the traced window in which the card is idle while the
    innermost program span is one of `names`; None unless the trace's
    clock is shown aligned with the spans' (`aligned`)."""
    p = rec.get("program")
    if not p or p.get("busy") is None or p["t_hi"] <= p["t_lo"] \
            or not aligned(p):
        return None
    idle = idle_by_span(p["busy"], p["spans"], p["t_lo"], p["t_hi"])
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / (
        p["t_hi"] - p["t_lo"])


def counter_delta(p: Dict) -> Optional[Tuple[Dict[str, int], int]]:
    """(the counters' change over the traced window, decode steps in it),
    from the samples taken after each step; None without samples."""
    samples = p.get("counters") or []
    if not samples:
        return None
    times = [t for t, _ in samples]
    i0 = bisect.bisect_right(times, p["t_lo"]) - 1
    i1 = bisect.bisect_right(times, p["t_hi"]) - 1
    if i1 < 0 or i1 <= i0:
        return None
    c1 = samples[i1][1]
    c0 = samples[i0][1] if i0 >= 0 else {k: 0 for k in c1}
    return {k: c1[k] - c0[k] for k in c1}, i1 - i0


def step_split(p: Dict) -> Dict[str, float]:
    """Mean milliseconds of the traced window's decode steps and of each of
    their parts."""
    steps = in_window(p, "engine.step")
    out = {}
    for name in ("engine.step",) + STEP_PARTS:
        total = 0.0
        for i in steps:
            s = p["spans"][i] if name == "engine.step" else \
                children(p, i).get(name)
            total += (s[2] - s[1]) if s else 0.0
        out[name] = 1e3 * total / len(steps) if steps else None
    return out


def kernel_leads(p: Dict) -> List[float]:
    """The lead (s) of each traced decode step's first kernel over the
    opening of its `engine.step.enqueue` span: positive when a kernel
    would start before the host launched it, i.e. the trace's clock runs
    early. Read on the steps whose pages made no copy: pages then launch
    no kernel (only the block table's copy, which `kernel_starts` leaves
    out), and in a traced run the card idles from the step's opening (a
    sync) to the first kernel of the step's forward."""
    starts = p.get("kernel_starts") or []
    out = []
    for i in in_window(p, "engine.step"):
        kids = children(p, i)
        pages, enq = kids.get("engine.step.pages"), \
            kids.get("engine.step.enqueue")
        if enq is None or (pages and pages[4].get("copies")):
            continue
        j = bisect.bisect_left(starts, p["spans"][i][1])
        if j < len(starts):
            out.append(enq[1] - starts[j])
    return out


def wait_slacks(p: Dict) -> List[float]:
    """For each traced decode step, the time (s) from the end of the card's
    last activity before its `engine.step.wait` closes (the read of the
    `finished` mask, which returns when the card is done) to that close:
    the host wakes after the card, so a negative slack means the trace's
    clock runs late."""
    busy = p.get("busy") or []
    starts = [a for a, _ in busy]
    out = []
    for i in in_window(p, "engine.step"):
        w = children(p, i).get("engine.step.wait")
        j = bisect.bisect_right(starts, w[2]) - 1 if w else -1
        if j >= 0:
            out.append(w[2] - busy[j][1])
    return out


ALIGN_S = 50e-6


def aligned(p: Dict) -> bool:
    """The trace's clock agrees with the spans' to `ALIGN_S` on every
    traced decode step: no first kernel leads its enqueue's opening, and
    the card's activity ends before the host's wait for it ends, by more
    than that."""
    leads, slacks = kernel_leads(p), wait_slacks(p)
    return bool(leads and slacks) and max(leads) <= ALIGN_S \
        and min(slacks) >= -ALIGN_S
