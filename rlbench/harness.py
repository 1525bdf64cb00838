"""What every driver shares: the window's clock, host spans around the
calls into the program's layers, the profiler's summary of a traced span,
and the lookup of the benchmark's files by name.

A driver runs one cell once. It builds the system from the configuration
and traffic files, warms it up (set-up), measures a window of whole
optimizer steps, checks what the window produced against the plain
reference, and returns a record from which `run.py` reads the metrics.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent


def load_json(rel: str) -> Dict:
    return json.loads((HERE.parent / rel).read_text())


def load_config(rel: str) -> Dict:
    """A configuration file as it is run: its published keys with the
    port's departures (`as_run`) laid over them."""
    c = load_json(rel)
    return {**c, **c.get("as_run", {})}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync() -> None:
    """Wait for the card (a no-op in a CPU rehearsal)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Clock:
    """The window's host clock. `pause()` takes out of the window the time
    in which the benchmark itself, with the device idle and the program
    stopped, copies weights for its check."""

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.paused = 0.0
        self.pauses: List[Tuple[float, float]] = []

    def now(self) -> float:
        return time.perf_counter() - self.t0 - self.paused

    def window_of(self, real: float) -> float:
        """The window-clock time of a `time.perf_counter()` reading (one
        inside a pause maps to the pause's start)."""
        out = real - self.t0
        for a, b in self.pauses:
            if real >= b:
                out -= b - a
            elif real > a:
                out -= real - a
        return out

    @contextlib.contextmanager
    def pause(self):
        sync()
        t = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.pauses.append((t, t1))
            self.paused += t1 - t


def setup_parts(marks: Dict[str, float]) -> Dict[str, float]:
    """Seconds of each part of set-up, from the clock's readings at the end
    of each (in order)."""
    out, prev = {}, 0.0
    for name, t in marks.items():
        out[name] = t - prev
        prev = t
    return out


class Spans:
    """Host-clock spans around calls into the program, each closed by a
    device sync so that it holds the call's device work. Off in untraced
    runs: the wrappers are only installed when tracing."""

    def __init__(self, clock: Clock):
        self.clock = clock
        self.spans: List[Tuple[str, float, float, Dict]] = []

    def wrap(self, owner, attr: str, label: str,
             info: Optional[Callable] = None):
        """Replace `owner.attr` by a timed call; `info(result, args)`
        adds fields to the span."""
        raw = getattr(owner, attr)

        def timed(*a, **k):
            sync()
            t0 = self.clock.now()
            out = raw(*a, **k)
            sync()
            t1 = self.clock.now()
            self.spans.append((label, t0, t1,
                               info(out, a, k) if info else {}))
            return out

        setattr(owner, attr, timed)
        return raw

    def wrap_decode(self, eng, steps: List, recording=None) -> None:
        """Time the engine's decode step as `wrap` does, but with no sync
        after the call, which ends in the step's own device-to-host read
        of its finished mask. Each step also appends to `steps` its span
        with the active rows' key lengths and block table, which the paged
        decode roofline reads, and then, with a `recording`
        (`program.Recording`), samples the engine's counters."""
        raw = eng.step

        def step(*a, **k):
            act = eng._host_active.copy()
            lens = eng._host_ncached[act] + 1
            table = eng.tables.table[act] if eng.tables is not None else None
            sync()
            t0 = self.clock.now()
            out = raw(*a, **k)
            t1 = self.clock.now()
            self.spans.append(("decode", t0, t1, {}))
            steps.append((t0, t1, lens, table))
            if recording is not None:
                recording.sample(eng)
            return out

        eng.step = step


MARK_KERNELS = ("spin_kernel", "sleep")  # `torch.cuda._sleep`: the mark


def end_mark() -> float:
    """A mark for the trace's clock taken by its end: the host's time when
    a sync on an idle card returns from a short sleep kernel. The start
    mark of `Profile` is taken by its start, at the host's time before the
    launch, which puts the kernels early by the launch's own time (the
    first launch under the profiler is slow)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return time.perf_counter()


class Profile:
    """The profiler on the card's activity over a traced span, with the
    marks that align the trace's clock to the host's: a mark kernel
    launched on an idle card at the start (host time `t_mark`, before the
    launch), and two end marks (`end_mark`, host times `ends`), one just
    after the start and one before the profiler stops, which
    `program.device_activity` reads."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        sync()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(100)
        sync()
        self.ends = [end_mark()]

    def summary(self, clock: Clock, t_lo: float, t_hi: float,
                spans: Spans) -> Dict:
        """The traced span [t_lo, t_hi) (window clock): device busy
        seconds, seconds by kernel name, and the idle gaps summed by the
        host span they fell in; with `acts`, every device activity on the
        trace's clock (`_kernels`), and the marks. The trace's clock is
        aligned to the host's by the start mark, then to the window's
        (`Clock.window_of`); activity outside [t_lo, t_hi), or inside one
        of the benchmark's own pauses, is cut off."""
        self.ends.append(end_mark())
        self.prof.__exit__(None, None, None)
        acts = _kernels(self.prof)
        mark = min(a for n, a, _ in acts
                   if any(k in n for k in MARK_KERNELS))
        shift = self.t_mark - mark
        ks = [(n, max(clock.window_of(a + shift), t_lo),
               min(clock.window_of(b + shift), t_hi))
              for n, a, b in acts]
        ks = [k for k in ks if k[2] > k[1]]
        window = t_hi - t_lo
        by_name: Dict[str, float] = {}
        for name, a, b in ks:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        busy_iv = _union([(a, b) for _, a, b in ks])
        busy = sum(b - a for a, b in busy_iv)
        gaps: Dict[str, float] = {}
        prev = t_lo
        for a, b in busy_iv + [(t_hi, t_hi)]:
            if a > prev:
                mid = 0.5 * (prev + a)
                label = "loop"
                for s in spans.spans:
                    if s[1] <= mid < s[2]:
                        label = s[0]
                gaps[label] = gaps.get(label, 0.0) + (a - prev)
            prev = max(prev, b)
        return {"busy_s": busy, "window_s": window, "by_name": by_name,
                "idle_by_host": gaps,
                "n_kernels": len(ks), "acts": acts, "ends": self.ends,
                "t_mark": self.t_mark}


def _kernels(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of every device activity in the trace, on
    the profiler's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns() / 1e9
        out.append((e.name(), start, start + e.duration_ns() / 1e9))
    return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
