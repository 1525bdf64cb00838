"""Host-clock spans of the port's layers, kept in memory.

    with trace.span("engine.step", version=v) as sp:
        ...
        if sp:                       # falsy when off: skip computing fields
            sp.set(rows=n)

A span records its name, its start and end on `time.perf_counter()`, the
index of the span open around it on the same thread (-1 at the top) and its
fields. Recording is off until `enable()`; off, `span` returns the shared
no-op `OFF` and reads no clock. On or off the recorder never synchronises
with the device and never reads it: spans say where the host spends its
time, and the device's time comes from a profiler trace laid on the same
clock. `take()` hands over the records, as (name, start, end, parent,
fields) tuples in the order the spans opened, and starts a new list. Counts
are not kept here: they are plain integer attributes of the objects that do
the work (`GenerationEngine.blocking_transfers`, `prefill_row_tokens`, ...).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Tuple

Record = Tuple[str, float, float, int, Dict[str, Any]]


class _Off:
    """The span handed out while recording is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **fields) -> None:
        pass


OFF = _Off()

_lock = threading.Lock()
_local = threading.local()       # .stack: [(generation, index)] per thread
_on = False
_gen = 0                         # bumped by take(): older indices are stale
_records: List[list] = []        # [name, start, end, parent, fields]


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, fields: Dict[str, Any]):
        self.rec = [name, 0.0, 0.0, -1, fields]

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            if stack and stack[-1][0] == _gen:
                self.rec[3] = stack[-1][1]
            stack.append((_gen, len(_records)))
            _records.append(self.rec)
        self.rec[1] = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.rec[2] = time.perf_counter()
        _local.stack.pop()
        return False

    def __bool__(self) -> bool:
        return True

    def set(self, **fields) -> None:
        """Add fields known only inside the span."""
        self.rec[4].update(fields)


def span(name: str, **fields):
    """A span named `name` around a `with` block; `OFF` while recording is
    off."""
    if not _on:
        return OFF
    return _Span(name, fields)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording new spans; those open still close."""
    global _on
    _on = False


def take() -> List[Record]:
    """The records since the last `take()` (a span still open has end 0.0),
    and a fresh list: a span opened later does not name one of these as its
    parent."""
    global _records, _gen
    with _lock:
        out, _records = _records, []
        _gen += 1
    return [tuple(r) for r in out]
