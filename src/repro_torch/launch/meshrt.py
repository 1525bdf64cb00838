"""Real-mesh runtime: the executed broadcast and the co-sim twin, the JAX
package's `launch/meshrt.py` on `torch.distributed`.

`MeshBroadcastExecutor` plugs into `WeightBroadcaster(executor=...)` and
turns every streamed publication into executed per-chunk transfers onto
the target engine's mesh (the runtime twin of
`launch.steps.lower_weight_update`), with the seconds of each chunk
measured. `record_cosim_trace` / `replay_trace` close the loop: a decode
run on a mesh engine is recorded (per-tick decode and per-chunk transfer
seconds) and replayed through the `EventLoop`'s `ActorStage`, so the
simulator's pause and lag accounting can be held against measurement.

torch is multi-controller: every rank of the process group runs these
functions in the same order. The CPU tests run them on gloo ranks; the
card runs gloo ranks on one device (`chip_smoke.py`'s mesh phase), and
the code takes whatever process group it is given.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.device import synchronize


class MeshBroadcastExecutor:
    """Executes the trainer -> engine streamed weight transfer on device
    buffers. For each chunk span (the same byte-balanced `chunk_spans`
    table the sim and the integrity gate use) the leaves are placed on the
    target engine's mesh:

      * publisher and engine share a mesh -> each leaf redistributed to
        the engine's placements (the executed form of
        `lower_weight_update(n_chunks=)`'s per-chunk reshard; torch
        compiles nothing here, so there is no per-span program to cache);
      * the engine owns its own ranks -> each leaf of the span gathered
        whole over the publisher's mesh, after which every rank of the
        engine's mesh keeps its own block of the copy (no further
        traffic; DTensor's redistribute works within one mesh only).

    Either way each chunk's seconds are measured with a device sync and
    returned, so `WeightBroadcaster.exec_records` holds executed transfer
    costs beside the sim's modeled ones. The record's `jit` is True when
    publisher and engine share a mesh (the JAX package's name for it).
    The executor keeps no reference to an engine."""

    def run(self, engine, params, version: int, n_chunks: int
            ) -> Dict[str, Any]:
        from repro_torch.core.weights import (chunk_spans, span_bytes,
                                              tree_flatten)
        from repro_torch.shardctx import is_distributed, redistribute

        leaves = tree_flatten(params)[0]
        spans = chunk_spans(leaves, n_chunks)
        sizes = span_bytes(leaves, spans)
        gshard = engine._pshard_leaves
        in_mesh = (leaves[0].device_mesh if is_distributed(leaves[0])
                   else None)
        use_jit = in_mesh is not None and in_mesh == engine.mesh
        chunks: List[List[Any]] = []
        per_chunk: List[float] = []
        for lo, hi in spans:
            t0 = time.perf_counter()
            if use_jit:
                out = [redistribute(x, engine.mesh, p)
                       for x, p in zip(leaves[lo:hi], gshard[lo:hi])]
            else:
                out = engine._place_leaves(leaves[lo:hi], gshard[lo:hi])
            synchronize(engine.device)
            per_chunk.append(time.perf_counter() - t0)
            chunks.append(out)
        return {"chunks": chunks, "per_chunk": per_chunk,
                "seconds": sum(per_chunk), "sizes": sizes,
                "nbytes": int(sum(sizes)), "version": int(version),
                "jit": use_jit}


# ---------------------------------------------------------------------------
# co-sim calibration: record a real-mesh trace, replay it in the EventLoop
# ---------------------------------------------------------------------------

def record_cosim_trace(engine, params, *, n_ticks: int = 24,
                       publish_every: int = 8, n_chunks: int = 4,
                       task=None) -> Dict[str, Any]:
    """Run a decode loop on a mesh engine and record its timeline.

    Every `publish_every` ticks a streamed publication of `params` begins;
    exactly one chunk installs per tick (the ActorStage `per_tick=1`
    discipline), placed on the engine's mesh through the executed-install
    path and measured. Each tick records the decode seconds (after a
    device sync), the chunk transfer seconds (None on chunk-free ticks),
    the engine's weight version after installs, and the newest version
    published so far: everything `replay_trace` needs."""
    engine.refill(0.0)
    ticks: List[Dict[str, Any]] = []
    version = engine.version
    published = version
    pending = 0
    for i in range(n_ticks):
        chunk_s = None
        if pending == 0 and i and i % publish_every == 0:
            published += 1
            sizes = engine.begin_weight_stream(params, published,
                                               n_chunks=n_chunks)
            pending = len(sizes)
        if pending:
            t0 = time.perf_counter()
            engine.stream_weight_chunk()
            chunk_s = time.perf_counter() - t0
            pending -= 1
        t0 = time.perf_counter()
        engine.step(task)
        synchronize(engine.device)
        decode_s = time.perf_counter() - t0
        if engine.n_active == 0:
            engine.refill(float(i))
        ticks.append({"decode_s": decode_s, "chunk_s": chunk_s,
                      "version": int(engine.version),
                      "published": int(published)})
    return {"ticks": ticks, "n_chunks": int(n_chunks),
            "publish_every": int(publish_every)}


class _ReplayEngine:
    """Minimal engine for trace replay: one always-active slot so the
    tick chain keeps firing, and streamed installs with GenerationEngine's
    return contract (False until the last chunk, version swap on it)."""

    def __init__(self):
        self.version = 0
        self.n_active = 1
        self.last_stream_installed = True
        self.problems: List[Any] = []
        self._left = 0
        self._v = 0

    def refill(self, now):
        return 0

    def step(self, task=None, now=0.0):
        return []

    def set_weights(self, params, version, recompute_kv=False):
        self.version = int(version)

    def begin_weight_stream(self, params, version, n_chunks=8,
                            recompute_kv=False, expect_digest=None):
        self._left, self._v = int(n_chunks), int(version)
        return [1] * int(n_chunks)

    def stream_weight_chunk(self, token=None):
        self._left -= 1
        if self._left > 0:
            return False
        self.version = self._v
        return True


def replay_trace(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Replay a recorded real-mesh trace through the EventLoop twin.

    The sim `ActorStage` is driven with the measured per-tick decode
    seconds as its step cost; each recorded publication is delivered as a
    stream whose chunks all arrive when the real run began installing,
    throttled to `per_tick=1` with `install_pause` set to that
    publication's mean measured chunk seconds. Returns the sim's predicted
    totals beside the measured ones: the co-sim check compares them (the
    per-tick decode is shared by construction, so any disagreement is the
    sim's pause and lag accounting)."""
    from repro_torch.core.events import ActorStage, EventLoop

    ticks = trace["ticks"]
    n_chunks = trace["n_chunks"]
    decode = [t["decode_s"] for t in ticks]
    # group consecutive chunk installs into publications
    pubs: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    for i, t in enumerate(ticks):
        if t["chunk_s"] is None:
            continue
        if cur is None:
            cur = {"start": i, "chunk_s": [], "version": t["published"]}
            pubs.append(cur)
        cur["chunk_s"].append(t["chunk_s"])
        if len(cur["chunk_s"]) == n_chunks:
            cur = None
    # closed-form sim tick-start times: t_{i+1} = t_i + decode_i + pause_i
    pause_of = {}
    for p in pubs:
        mean = sum(p["chunk_s"]) / len(p["chunk_s"])
        p["mean"] = mean
        for o in range(len(p["chunk_s"])):
            pause_of[p["start"] + o] = mean
    starts = [0.0]
    for i in range(len(ticks)):
        starts.append(starts[-1] + decode[i] + pause_of.get(i, 0.0))

    loop = EventLoop()
    eng = _ReplayEngine()
    versions_sim: List[int] = []
    calls = [0]

    def step_cost(h):
        versions_sim.append(eng.version)
        i = calls[0]
        calls[0] += 1
        return decode[min(i, len(decode) - 1)]

    stage = ActorStage(loop, eng, name="replay", step_cost=step_cost,
                       auto_refill=False, chain=True)
    for p in pubs:
        # safely inside (t_{start-1}, t_start]: the first install lands on
        # exactly the tick the real run installed on
        arrive = 0.5 * (starts[p["start"] - 1] + starts[p["start"]])
        loop.post(arrive, lambda now, p=p: stage.deliver_stream(
            None, p["version"], [now] * len(p["chunk_s"]),
            install_pause=p["mean"], per_tick=1))
    stage.start(0.0)
    loop.run(until=lambda: stage.ticks_completed >= len(ticks))

    measured_total = sum(decode) + sum(s for p in pubs for s in p["chunk_s"])
    measured_pause = (sum(sum(p["chunk_s"]) for p in pubs) / len(pubs)
                      if pubs else 0.0)
    lag_meas = sum(t["published"] - t["version"]
                   for t in ticks) / len(ticks)
    lag_sim = sum(t["published"] - v
                  for t, v in zip(ticks, versions_sim)) / len(ticks)
    return {
        "sim_total_s": stage.time,
        "measured_total_s": measured_total,
        "sim_pause_per_update": (stage.pause_total / stage.updates_applied
                                 if stage.updates_applied else 0.0),
        "measured_pause_per_update": measured_pause,
        "updates_sim": stage.updates_applied,
        "updates_measured": len(pubs),
        "mean_lag_sim": lag_sim,
        "mean_lag_measured": lag_meas,
        "versions_sim": versions_sim,
    }
