"""Event-driven orchestration: one discrete-event scheduler on which the
pipeline's stages post callbacks against a shared simulated clock and
react to each other's completions. `PipelineRL` and `ConventionalRL` are
configurations of the same stage library. A port of the JAX package's
`core/events.py` driving the port's engines, Preprocessor and Trainer; its
fault injection (`Fault`, `FaultPlan`) is not ported yet (ROADMAP.md
queue A.7).

  ActorStage        owns one `GenerationEngine`; self-schedules decode
                    ticks; at each tick boundary it first installs any
                    arrived weight publications (atomic swaps or streamed
                    chunks, the only place weights may change, so per-token
                    version stamps stay exact), then steps the engine,
                    delivers finished rollouts downstream, and refills.
                    `preempt(at, d)` takes the engine offline for [at,
                    at+d); in-flight slots are untouched and resume.
  PoolRouter        admission between one shared prompt source and the
                    pool's engines: fifo, shortest_queue, length_affinity;
                    a paged engine short of pages declines the pull.
  HealthMonitor     watchdog over the pool: hang and straggler detection
                    from the heartbeats the stages record.
  PreprocessStage   pulls B rollouts from the SampleQueue when free, holds
                    them for `stage_time`, delivers the processed batch to
                    the trainer: an overlapped stage on its own chips
                    (paper Fig. 4), at most one batch ahead.
  TrainerStage      consumes batches, runs the real optimizer step eagerly,
                    stamps completion on the simulated clock, publishes
                    weights through the WeightBroadcaster every
                    `update_every` versions, and can stall for checkpoints.
  WeightBroadcaster turns a publication into per-engine delivery schedules
                    costed by `HardwareModel.broadcast_time`: atomic (the
                    engine pauses for the whole transfer) or streamed
                    (chunks overlap decode; the engine pauses
                    `bcast_install_flash` per chunk and pointer-swaps on
                    the last one).

Clock invariants: events fire in nondecreasing time order (FIFO on
ties); a stage's own timeline is nondecreasing; rollout `finished_at`
stamps are the actor-tick completion times. Times are flashes of the
Appendix-A model (`core/sim.py`), not device times.

Ownership runs one way: the orchestrator holds the loop, the loop's heap
holds the stages' pending callbacks, and the stages hold the engines and
the trainer. A stage refers to its loop through a `weakref.proxy` (its
owner keeps the loop alive), and a callback that leads back up to an
owner is a `weak_method`. So a dropped orchestrator frees its engines'
caches and the trainer's tensors by reference counting alone, without
waiting for the cyclic garbage collector, and its pending events still
survive between `run` calls while it lives.
"""
from __future__ import annotations

import heapq
import os
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.weights import (chunk_spans, chunk_token, span_bytes,
                                      stream_digest, tree_bytes, tree_flatten)
from repro_torch.data.packing import Rollout, pack

__all__ = ["ActorStage", "EventLoop", "HealthMonitor", "LagGate",
           "PoolRouter", "PreprocessStage", "TrainerStage",
           "WeightBroadcaster", "apply_group_baseline", "chunk_spans",
           "chunk_token", "lag_stats", "span_bytes", "stream_digest",
           "tree_bytes"]


# ---------------------------------------------------------------------------
# event loop
# ---------------------------------------------------------------------------

def _weakly(loop: "EventLoop") -> "EventLoop":
    """A stage's reference to its loop: a proxy that does not keep it
    alive (the stage's owner does)."""
    return loop if isinstance(loop, weakref.ProxyTypes) else \
        weakref.proxy(loop)


def weak_method(method: Callable) -> Callable:
    """`method` (a bound method) as a callable that does not keep its
    object alive: a stage calls back into its owner through one, so the
    owner is freed by reference counting once dropped. Calling it after
    the object is gone raises ReferenceError."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        fn = ref()
        if fn is None:
            raise ReferenceError("weak_method: the object is gone")
        return fn(*args, **kwargs)

    return call


class EventLoop:
    """Minimal deterministic discrete-event scheduler: a time-ordered heap
    of callbacks with FIFO tie-breaking. `run(until=...)` processes events
    until the predicate holds or the heap drains; pending events survive,
    so orchestrators built on top are resumable (`run(n)` then `run(m)`)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, Callable[[float], None]]] = []
        self._seq = 0
        self.now = 0.0
        self.events_processed = 0

    def post(self, time: float, fn: Callable[[float], None]) -> None:
        """Schedule `fn(fire_time)`. Times before `now` are clamped to
        `now` (a stage may not rewind the clock)."""
        heapq.heappush(self._heap, (max(time, self.now), self._seq, fn))
        self._seq += 1

    def __len__(self) -> int:
        return len(self._heap)

    def step(self) -> bool:
        """Process the earliest event; False if none remain."""
        if not self._heap:
            return False
        t, _, fn = heapq.heappop(self._heap)
        self.now = t
        self.events_processed += 1
        fn(t)
        return True

    def run(self, until: Optional[Callable[[], bool]] = None,
            max_events: int = 10_000_000) -> None:
        for _ in range(max_events):
            if until is not None and until():
                return
            if not self.step():
                return
        raise RuntimeError("EventLoop.run exceeded max_events — "
                           "a stage is posting events without progress")


# ---------------------------------------------------------------------------
# shared metric helpers (exported to pipeline.py for API compatibility)
# ---------------------------------------------------------------------------

def lag_stats(rollouts: List[Rollout], trainer_version: int):
    """(max, mean) token lag of completion tokens vs `trainer_version`."""
    lags = []
    for r in rollouts:
        mask = np.arange(r.length) >= r.prompt_len
        lags.append((trainer_version - r.weight_versions)[mask])
    if not lags:
        return 0.0, 0.0
    cat = np.concatenate(lags)
    if cat.size == 0:
        return 0.0, 0.0
    return float(cat.max()), float(cat.mean())


def apply_group_baseline(rollouts: List[Rollout]) -> List[Rollout]:
    """GRPO-style: reward <- reward - mean(rewards of same-prompt rollouts).
    Returns shallow copies so queue bookkeeping is untouched."""
    import copy
    groups: Dict[int, List[float]] = {}
    for r in rollouts:
        groups.setdefault(r.prompt_key, []).append(r.reward)
    means = {k: float(np.mean(v)) for k, v in groups.items()}
    out = []
    for r in rollouts:
        r2 = copy.copy(r)
        r2.reward = r.reward - means[r.prompt_key]
        out.append(r2)
    return out


# ---------------------------------------------------------------------------
# periodic-asynchrony gate (DESIGN.md §12)
# ---------------------------------------------------------------------------

class LagGate:
    """Bounded-staleness barrier shared by the actor pool
    (`PipelineConfig.max_lag`): an actor whose engine weights are more
    than `max_lag` versions behind the learner pauses — via the PR-5
    preemption-window machinery — until its pending weight delivery
    installs, instead of stamping tokens that the lag bound would force
    the trainer to discard. `max_lag=0` is conventional-RL lockstep
    (every sampled token is trained at lag 0); `max_lag=None` (no gate)
    is the paper's free-running pipeline.

    The gate is keyed on `engine.version` — what a *new* token would be
    stamped with — never on the oldest in-flight stamp: pausing decode
    can't freshen an already-stamped token, it can only stop digging, so
    gating on in-flight stamps would deadlock (the rollout could never
    finish). In-flight staleness is bounded instead by the pack-time
    mask (`pack(..., max_lag=...)`), which guarantees no over-bound
    token reaches the objective."""

    def __init__(self, max_lag: int, trainer_version: Callable[[], int]):
        self.max_lag = int(max_lag)
        self.trainer_version = trainer_version
        self.blocks = 0        # gate decisions that paused an actor
        self.parks = 0         # pauses with no delivery yet scheduled
        self.wait_total = 0.0  # flashes of decode deferred by the gate

    def blocked(self, actor: "ActorStage") -> bool:
        """Would a token sampled now exceed the lag bound?"""
        return (self.trainer_version()
                - int(actor.engine.version)) > self.max_lag

    def stats(self) -> Dict[str, Any]:
        return {"max_lag": self.max_lag, "blocks": self.blocks,
                "parks": self.parks, "wait_total": self.wait_total}


# ---------------------------------------------------------------------------
# actor stage
# ---------------------------------------------------------------------------

class ActorStage:
    """One generation engine on the event loop.

    step_cost(h) / prefill_cost(tokens, invocations) are the stage's cost
    model: PipelineRL passes HardwareModel closures over its chip share.
    `auto_refill=False` drains the engine and calls `on_drained`
    (ConventionalRL's phase end). Weight publications
    arrive via `deliver_atomic` / `deliver_stream` and are installed only
    at tick boundaries (Algorithm 2 l. 9-11), charging the decode-pause
    the HardwareModel assigns to the mode.
    """

    def __init__(self, loop: EventLoop, engine, *,
                 task=None, name: str = "actor0",
                 step_cost: Callable[[float], float] = lambda h: 1.0,
                 prefill_cost: Callable[[int, int], float] = lambda t, i: 0.0,
                 page_cost: Callable[[int], float] = lambda p: 0.0,
                 deliver: Optional[Callable[[List[Rollout], float], None]] = None,
                 auto_refill: bool = True,
                 on_drained: Optional[Callable[[float], None]] = None,
                 recompute_kv: bool = False,
                 lag_gate: Optional["LagGate"] = None):
        self.loop, self.engine = _weakly(loop), engine
        self.task, self.name = task, name
        self.step_cost, self.prefill_cost = step_cost, prefill_cost
        self.page_cost = page_cost
        # periodic-asynchrony (DESIGN.md §12): pool-shared staleness gate
        self.lag_gate = lag_gate
        self.lag_pauses = 0                # gate deferrals taken
        self.lag_wait_total = 0.0          # decode flashes deferred
        self._lag_parked = False           # offline awaiting a publication
        self._lag_parked_at = 0.0
        self._lag_carry_pause = 0.0        # install pause owed at unpark
        self.deliver = deliver or (lambda rollouts, t: None)
        self.auto_refill, self.on_drained = auto_refill, on_drained
        self.recompute_kv = recompute_kv
        self.running = False
        self.time = 0.0                    # this engine's own clock
        # weight deliveries
        self._atomic: List[Tuple[float, Any, int, float]] = []
        self._stream: Optional[Dict[str, Any]] = None
        self._next_stream: Optional[Tuple] = None   # newest pending publish
        # timed preemption windows [start, end) — sorted by start
        self._preempt: List[Tuple[float, float]] = []
        self.preempt_total = 0.0           # wall-time spent offline
        self.preemptions_taken = 0         # deferrals actually hit
        # failure / recovery (DESIGN.md §8): `fail` crashes the engine
        # mid-decode, `restore` brings it back after a catch-up sync
        self.failed = False
        self.failures = 0
        self.recoveries = 0
        self.rollouts_lost = 0             # in-flight sequences killed
        self.prompts_salvaged = 0          # prompts handed back to the pool
        self.failed_at: Optional[float] = None
        self.downtime = 0.0                # wall-time spent crashed
        self._epoch = 0                    # bumped on fail: stale queued
        #                                    tick chains become no-ops
        self.ticks_completed = 0
        self.last_tick_at: Optional[float] = None    # heartbeat
        self.ewma_tick_cost: Optional[float] = None  # EWMA decode-step
        #   cost (pauses/prefill excluded). step_cost(h) = h/U(h)/speed
        #   is load-independent in the linear-utilization region, so
        #   after the monitor multiplies by the declared speed this is a
        #   cross-engine-comparable progress statistic: busy != straggler
        # accounting (read by orchestrators / benchmarks)
        self.updates_applied = 0
        self.streams_completed = 0
        self.streams_aborted = 0
        self.pause_total = 0.0             # decode pause charged to updates
        self.pause_log: List[Tuple[int, float]] = []   # (version, pause)

    _EWMA_ALPHA = 0.25                     # per-tick progress smoothing

    # ---- weight delivery (called by the WeightBroadcaster) -------------
    def deliver_atomic(self, arrive: float, params, version: int,
                       pause: float) -> None:
        """Whole-tree publication arriving at `arrive`; the engine pauses
        `pause` flashes at the install boundary (the blocking transfer).
        Dropped when the engine is crashed — the restore path re-syncs."""
        if self.failed:
            return
        self._atomic.append((arrive, params, version, pause))
        self._atomic.sort(key=lambda x: x[0])
        self._lag_unpark(arrive)

    def deliver_stream(self, params, version: int, arrivals: Sequence[float],
                       install_pause: float, per_tick: int = 0,
                       recompute_kv: Optional[bool] = None,
                       tokens: Optional[Sequence[Optional[int]]] = None,
                       n_chunks: Optional[int] = None,
                       digest: Optional[int] = None) -> None:
        """Chunked publication: chunk k arrives at arrivals[k]; each
        install pauses decode `install_pause`; pointer-swap after the
        last. While a stream is in flight, a new publication *waits* (the
        in-flight transfer always completes, so the policy keeps making
        forward progress even when `broadcast_time` exceeds the publish
        interval) — but only the newest waiting publication survives:
        superseded pending ones are counted in `streams_aborted`.

        Integrity gate: `tokens[k]` is the checksum carried by
        transmission k; the engine recomputes it from its own span table
        and rejects mismatches without touching the shadow buffer.
        `digest` is the whole-publication checksum verified before the
        pointer swap."""
        if self.failed:
            return
        rk = self.recompute_kv if recompute_kv is None else recompute_kv
        if self._stream is not None:
            if self._next_stream is not None:
                self.streams_aborted += 1
            self._next_stream = (params, version, list(arrivals),
                                 install_pause, per_tick, rk,
                                 list(tokens) if tokens is not None else None,
                                 n_chunks, digest)
            if arrivals:
                self._lag_unpark(list(arrivals)[-1])
            return
        nc = len(arrivals) if n_chunks is None else int(n_chunks)
        sizes = self.engine.begin_weight_stream(
            params, version, n_chunks=nc, recompute_kv=rk,
            expect_digest=digest)
        self._stream = dict(version=version, arrivals=deque(arrivals),
                            tokens=(deque(tokens) if tokens is not None
                                    else None),
                            n_chunks=len(sizes), pause=install_pause,
                            per_tick=per_tick, accum=0.0)
        if arrivals:
            self._lag_unpark(list(arrivals)[-1])

    def _install_weights(self, now: float) -> float:
        """Apply every publication that has arrived by `now`; returns the
        decode pause charged to this tick."""
        pause = 0.0
        while self._atomic and self._atomic[0][0] <= now:
            _, params, version, cost = self._atomic.pop(0)
            # an atomic swap supersedes any in-flight/pending stream
            if self._stream is not None:
                self.streams_aborted += 1
                self._stream = None
            if self._next_stream is not None:
                self.streams_aborted += 1
                self._next_stream = None
            self.engine.set_weights(params, version,
                                    recompute_kv=self.recompute_kv)
            pause += cost
            self.updates_applied += 1
            self.pause_log.append((version, cost))
        st = self._stream
        if st is not None:
            installed = 0
            while st["arrivals"] and st["arrivals"][0] <= now:
                if st["per_tick"] and installed >= st["per_tick"]:
                    break
                st["arrivals"].popleft()
                tok = (st["tokens"].popleft() if st["tokens"] is not None
                       else None)
                done = self.engine.stream_weight_chunk(token=tok)
                pause += st["pause"]
                st["accum"] += st["pause"]
                installed += 1
                if done:
                    self.updates_applied += 1
                    if getattr(self.engine, "last_stream_installed", True):
                        self.streams_completed += 1
                    else:
                        # torn stream caught by the pre-swap digest gate:
                        # nothing installed, μ stays on the old weights
                        self.updates_applied -= 1
                        self.streams_aborted += 1
                    self.pause_log.append((st["version"], st["accum"]))
                    self._stream = None
                    # promote the newest publication that waited for the
                    # in-flight transfer to finish
                    if self._next_stream is not None:
                        nxt, self._next_stream = self._next_stream, None
                        self.deliver_stream(nxt[0], nxt[1], nxt[2], nxt[3],
                                            per_tick=nxt[4],
                                            recompute_kv=nxt[5],
                                            tokens=nxt[6], n_chunks=nxt[7],
                                            digest=nxt[8])
                    break
        self.pause_total += pause
        return pause

    def _pending_install_time(self) -> Optional[float]:
        """Earliest future time a *version-advancing* install can land:
        the first queued atomic swap, the in-flight stream's last chunk
        (the pointer swap), or the pending next stream's last chunk. None
        when no publication is in flight (the gate must park, not spin)."""
        cands = []
        if self._atomic:
            cands.append(self._atomic[0][0])
        if self._stream is not None and self._stream["arrivals"]:
            cands.append(self._stream["arrivals"][-1])
        if self._next_stream is not None and self._next_stream[2]:
            cands.append(self._next_stream[2][-1])
        return min(cands) if cands else None

    def _lag_unpark(self, t: float) -> None:
        """Resume a gate-parked actor once a publication is scheduled;
        the owed install pause is served before the first post-park tick."""
        if not self._lag_parked or self.failed:
            return
        self._lag_parked = False
        carry, self._lag_carry_pause = self._lag_carry_pause, 0.0
        wake = max(t, self._lag_parked_at) + carry
        self.lag_wait_total += wake - self._lag_parked_at
        if self.lag_gate is not None:
            self.lag_gate.wait_total += wake - self._lag_parked_at
        self.running = True
        self._post_tick(wake)

    # ---- preemption (DESIGN.md §7 pool scheduling) ---------------------
    def preempt(self, start: float, duration: float) -> None:
        """Take the engine offline for [start, start+duration): any tick
        that would *begin* inside the window is deferred to the window
        end (a decode step already under way when the window opens
        completes — discrete-event granularity, checkpoint-style
        preemption). In-flight slots keep their KV/recurrent state and
        resume untouched; weight publications that arrive during the
        window install at the deferred tick. Overlapping and abutting
        windows compose."""
        if duration <= 0:
            return
        self._preempt.append((float(start), float(start) + float(duration)))
        self._preempt.sort()

    def _preempt_until(self, now: float) -> Optional[float]:
        """Resume time if `now` falls inside a preemption window (chained
        windows are followed transitively); None when online. Windows
        wholly in the past are discarded."""
        t = now
        for s, e in self._preempt:
            if s <= t < e:
                t = e
        self._preempt = [(s, e) for (s, e) in self._preempt if e > t]
        return t if t > now else None

    # ---- failure / recovery (DESIGN.md §8) -----------------------------
    def fail(self, now: float) -> List[Any]:
        """Crash the engine at `now`, mid-decode: every live slot's
        rollout-in-progress is lost (its sampled tokens die with the
        process — counted in `rollouts_lost`), but the slots' *prompts*
        are salvaged and returned so the pool can re-offer them to
        surviving engines. Pending weight deliveries (atomic and
        streamed) are dropped; the restore path collapses everything the
        engine missed into one catch-up atomic sync. Idempotent: failing
        a failed stage salvages nothing."""
        if self.failed:
            return []
        self.failed = True
        self.failed_at = now
        self.failures += 1
        self._epoch += 1          # kill any queued tick chain
        self.running = False
        self._lag_parked = False  # restore() restarts the tick chain
        self._lag_carry_pause = 0.0
        self._atomic.clear()
        self._stream = None
        self._next_stream = None
        eng = self.engine
        salvaged = [eng.problems[s] for s in np.where(eng._host_active)[0]
                    if eng.problems[s] is not None]
        # paged engines may hold prompts parked by page-exhaustion
        # deferral/preemption — those were admitted work too, and must be
        # pulled BEFORE reset_slots drops the deferral queue
        drain = getattr(eng, "drain_deferred", None)
        if drain is not None:
            salvaged.extend(drain())
        self.rollouts_lost += eng.reset_slots()
        self.prompts_salvaged += len(salvaged)
        return salvaged

    def restore(self, now: float, params=None,
                version: Optional[int] = None) -> None:
        """Bring a failed engine back online at `now` (crash restart or
        elastic rejoin). `params`/`version` is the catch-up atomic weight
        sync — every publication the engine missed while down, collapsed
        to the newest — applied BEFORE admission resumes, so a rejoining
        engine never decodes under stale weights and its per-token
        version stamps stay exact from the first post-rejoin token."""
        if not self.failed:
            return
        self.failed = False
        self.recoveries += 1
        # a restarted process starts with a clean health record: the old
        # heartbeat/progress EWMAs describe the pre-outage (possibly
        # degraded) incarnation and must not flag the fresh one
        self.last_tick_at = None
        self.ewma_tick_cost = None
        if self.failed_at is not None:
            self.downtime += now - self.failed_at
            self.failed_at = None
        if params is not None:
            self.engine.set_weights(params, int(version or 0),
                                    recompute_kv=self.recompute_kv)
            self.updates_applied += 1
        self.start(now)

    # ---- lifecycle -----------------------------------------------------
    def start(self, t: float) -> None:
        if not self.running and not self.failed:
            self.running = True
            self._lag_parked = False   # an explicit start supersedes a park
            self._post_tick(t)

    def _post_tick(self, t: float) -> None:
        """Schedule the next tick under the current failure epoch: a
        crash between post and fire invalidates the chain (the closure's
        epoch goes stale), so a restored stage never runs two interleaved
        tick chains."""
        epoch = self._epoch
        self.loop.post(t, lambda now: self._tick(now, epoch))

    def _refill(self, now: float) -> float:
        inv0 = getattr(self.engine, "prefill_invocations", 0)
        admitted = self.engine.refill(now)
        if not admitted:
            return 0.0
        inv = getattr(self.engine, "prefill_invocations", 0) - inv0
        # paged engines report the pages the admission actually allocated
        # (a COW-forked GRPO group costs its prefix pages once) — the page
        # cost models allocator/table traffic on top of the prefill flops
        pages = getattr(self.engine, "last_admit_pages", 0)
        return (self.prefill_cost(self.engine.last_admit_prefill_tokens, inv)
                + self.page_cost(pages))

    def _tick(self, now: float, epoch: int) -> None:
        """One decode step: install weights -> (refill) -> step -> deliver
        -> (refill) -> reschedule."""
        if epoch != self._epoch or self.failed:
            return   # stale chain from before a crash, or offline
        resume = self._preempt_until(now)
        if resume is not None:
            self.preempt_total += resume - now
            self.preemptions_taken += 1
            self._post_tick(resume)
            return
        pause = self._install_weights(now)
        # periodic-asynchrony gate (DESIGN.md §12): checked AFTER installs
        # so an already-arrived publication unblocks this very tick. A
        # blocked actor defers to its pending delivery through the PR-5
        # preemption machinery (HealthMonitor-exempt by construction); the
        # install pause already charged above rides the window so its
        # wall-time isn't dropped from the timeline.
        if self.lag_gate is not None and self.lag_gate.blocked(self):
            self.lag_gate.blocks += 1
            self.lag_pauses += 1
            wake = self._pending_install_time()
            if wake is None:
                # nothing published yet: park until a delivery lands
                # (deliver_atomic / deliver_stream unpark)
                self.lag_gate.parks += 1
                self._lag_parked = True
                self._lag_parked_at = now
                self._lag_carry_pause += pause
                self.running = False
                return
            wake = max(wake, now + 1e-9)
            self.lag_wait_total += wake - now
            self.lag_gate.wait_total += wake - now
            self.preempt(now, (wake - now) + pause)
            self._post_tick(now)
            return
        c_pre = 0.0
        if self.auto_refill and self.engine.n_active == 0:
            c_pre += self._refill(now)
        h = self.engine.n_active
        if h == 0:
            # nothing to decode: drained (conventional phase end) or the
            # source declined. Any weight-install pause stays on the
            # timeline.
            t = now + pause + c_pre + self.step_cost(0)
            self.time = max(self.time, t)
            self.deliver([], t)
            self.running = False
            if self.on_drained is not None:
                self.on_drained(t)
            return
        finished = self.engine.step(self.task, now=now)
        cost = self.step_cost(h)
        t_done = now + pause + c_pre + cost
        for r in finished:
            r.finished_at = t_done
        self.time = t_done
        # heartbeat + per-tick progress EWMA (the HealthMonitor's inputs)
        self.ticks_completed += 1
        self.last_tick_at = t_done
        self.ewma_tick_cost = cost if self.ewma_tick_cost is None else (
            self._EWMA_ALPHA * cost
            + (1.0 - self._EWMA_ALPHA) * self.ewma_tick_cost)
        self.deliver(finished, t_done)
        if self.auto_refill:
            t_done += self._refill(t_done)
        if self.engine.n_active == 0 and not self.auto_refill:
            self.running = False
            if self.on_drained is not None:
                self.on_drained(t_done)
            return
        self._post_tick(t_done)


# ---------------------------------------------------------------------------
# pool router (priority/affinity admission across the actor pool)
# ---------------------------------------------------------------------------

class PoolRouter:
    """Pluggable admission layer between one shared prompt source and the
    engines of an actor pool (DESIGN.md §7 "Pool scheduling").

    Engines keep their pull-based admission: each free slot asks its
    per-engine view (`source_for(i)`) for a prompt during refill. The
    router decides what that pull returns:

      fifo             pass-through: the requesting engine takes the next
                       prompt from the source — bit-identical to wiring
                       the source into every engine directly (default).
      shortest_queue   the requesting engine is granted the next prompt
                       only while its speed-normalized outstanding decode
                       work is within `slack` tokens of the pool minimum;
                       otherwise the pull is declined (the slot stays
                       free and is re-offered at the engine's next tick),
                       so slow/deep engines stop hoarding prompts.
      length_affinity  the router keeps up to `lookahead` pending prompts
                       drawn from the source; engines at or above the
                       mean pool speed take the *longest* pending prompt,
                       slower engines the *shortest* — long prompts'
                       prefill (and their short remaining completion
                       budget) land on the cheapest compute.

    All decisions read only the prompt stream and the engines' host
    mirrors (`_host_active`/`_host_ncached` — the prompt-length histogram
    the engines already keep on host): no wall-clock, no RNG, so routing
    is deterministic under the simulated clock.
    """

    POLICIES = ("fifo", "shortest_queue", "length_affinity")

    def __init__(self, source: Callable[[], Optional[Any]],
                 policy: str = "fifo", lookahead: int = 0,
                 slack: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"choose from {self.POLICIES}")
        self.source, self.policy = source, policy
        self.lookahead, self.slack = int(lookahead), slack
        # sim-clock accessor: only read for recovery telemetry (salvaged-
        # prompt re-admission latency), never for routing decisions — so
        # routing stays deterministic and clockless as before
        self.clock = clock or (lambda: 0.0)
        self.pending: deque = deque()
        self.engines: List[Any] = []
        self.speeds: List[float] = []
        self.assigned: List[int] = []
        self.assigned_tokens: List[int] = []
        self.declined: List[int] = []
        self.alive: List[bool] = []
        # §10 straggler demotion weight (1.0 = healthy), set by the
        # HealthMonitor; multiplies declared speed in routing scores
        self.health: List[float] = []
        # failure recovery (DESIGN.md §8)
        self.requeued = 0
        self.requeue_latency: List[float] = []

    def attach(self, engines: Sequence[Any],
               speeds: Optional[Sequence[float]] = None) -> None:
        self.engines = list(engines)
        n = len(self.engines)
        self.speeds = [float(s) for s in speeds] if speeds is not None \
            else [1.0] * n
        if len(self.speeds) != n:
            raise ValueError(f"{len(self.speeds)} speeds for {n} engines")
        self.assigned = [0] * n
        self.assigned_tokens = [0] * n
        self.declined = [0] * n
        self.alive = [True] * n
        self.health = [1.0] * n
        if self.lookahead <= 0:
            self.lookahead = sum(e.ec.n_slots for e in self.engines)
        if self.slack is None:
            self.slack = float(max(e.ec.max_len for e in self.engines))

    # ---- elastic pool / failure recovery (DESIGN.md §8) ----------------
    def add_engine(self, engine, speed: float = 1.0) -> int:
        """Elastic join: extend the pool with one engine at runtime."""
        self.engines.append(engine)
        self.speeds.append(float(speed))
        self.assigned.append(0)
        self.assigned_tokens.append(0)
        self.declined.append(0)
        self.alive.append(True)
        self.health.append(1.0)
        return len(self.engines) - 1

    def set_alive(self, i: int, alive: bool) -> None:
        """Crashed/detached engines leave the routing population: load
        comparisons and speed means ignore them (they cannot pull anyway
        — a dead stage never refills)."""
        self.alive[i] = bool(alive)

    def set_health(self, i: int, health: float) -> None:
        """Straggler demotion (DESIGN.md §10): scale engine `i`'s
        *effective* speed by `health` in (0, 1]. Routing treats a demoted
        engine as a proportionally slower chip — shortest_queue stops
        granting it prompts once its normalized backlog rises, and
        length_affinity steers long prompts away — without removing it
        from the pool. The HealthMonitor sets this from the measured
        degradation and resets it to 1.0 on recovery."""
        self.health[i] = min(max(float(health), 1e-3), 1.0)

    def _eff_speed(self, j: int) -> float:
        return self.speeds[j] * self.health[j]

    def requeue(self, problems: Sequence[Any],
                now: Optional[float] = None) -> None:
        """Recovery path: salvaged prompts from a failed engine re-enter
        at the FRONT of the pending buffer — they are the pool's oldest
        admitted work, so they must win the next pulls — and are
        timestamped so `stats()` can report re-admission latency."""
        t = self.clock() if now is None else now
        for p in reversed(list(problems)):
            p._salvaged_at = t  # type: ignore[attr-defined]
            self.pending.appendleft(p)
        self.requeued += len(problems)

    def source_for(self, i: int) -> Callable[[], Optional[Any]]:
        """The prompt-source callable engine `i` pulls from. It refers to
        the router weakly: the router holds the engines."""
        request = weak_method(self.request)
        return lambda: request(i)

    # ---- internals -----------------------------------------------------
    def _load(self, j: int) -> float:
        """Speed-normalized outstanding decode work of engine j: remaining
        token budget of its active slots, in slow-chip token units."""
        eng = self.engines[j]
        act = eng._host_active
        rem = int((eng.ec.max_len - 1 - eng._host_ncached[act]).sum())
        return rem / max(self._eff_speed(j), 1e-9)

    def _draw(self) -> Optional[Any]:
        if self.pending:
            return self.pending.popleft()
        return self.source()

    def _admissible(self, i: int, prob: Any) -> bool:
        """Page-costed admission gate (DESIGN.md §9): a paged engine that
        cannot back the prompt's blocks right now declines the pull — the
        prompt stays pooled for an engine with free pages instead of
        parking in the full engine's deferral queue."""
        fn = getattr(self.engines[i], "can_admit", None)
        return fn is None or bool(fn(len(prob.prompt_ids)))

    def _grant(self, i: int, prob: Any) -> Any:
        self.assigned[i] += 1
        self.assigned_tokens[i] += len(prob.prompt_ids)
        t0 = getattr(prob, "_salvaged_at", None)
        if t0 is not None:
            self.requeue_latency.append(self.clock() - t0)
            prob._salvaged_at = None
        return prob

    # ---- the per-engine pull -------------------------------------------
    def request(self, i: int) -> Optional[Any]:
        if self.policy == "shortest_queue":
            loads = [self._load(j) for j in range(len(self.engines))]
            floor = min((l for l, ok in zip(loads, self.alive) if ok),
                        default=0.0)
            if loads[i] - floor > self.slack:
                self.declined[i] += 1
                return None
        if self.policy != "length_affinity":
            prob = self._draw()
            if prob is None:
                return None
            if not self._admissible(i, prob):
                self.pending.appendleft(prob)  # keep pool order
                self.declined[i] += 1
                return None
            return self._grant(i, prob)
        # length_affinity: top up the pending buffer, then pick by length
        while len(self.pending) < self.lookahead:
            p = self.source()
            if p is None:
                break
            self.pending.append(p)
        if not self.pending:
            return None
        lens = [len(p.prompt_ids) for p in self.pending]
        eff = [self._eff_speed(j) for j in range(len(self.engines))]
        live = [s for s, ok in zip(eff, self.alive) if ok] or eff
        mean_speed = sum(live) / max(len(live), 1)
        if eff[i] >= mean_speed:
            # ties break toward the earliest pending prompt (FIFO within
            # equal lengths) so routing stays deterministic
            k = max(range(len(lens)), key=lambda j: (lens[j], -j))
        else:
            k = min(range(len(lens)), key=lambda j: (lens[j], j))
        prob = self.pending[k]
        if not self._admissible(i, prob):
            self.declined[i] += 1
            return None
        del self.pending[k]
        return self._grant(i, prob)

    def stats(self) -> Dict[str, Any]:
        lat = self.requeue_latency
        return {
            "policy": self.policy,
            "pending": len(self.pending),
            "prompts_requeued": self.requeued,
            "requeues_readmitted": len(lat),
            "requeue_latency_mean": float(np.mean(lat)) if lat else 0.0,
            "requeue_latency_max": float(np.max(lat)) if lat else 0.0,
            "engines": [
                {"assigned": a, "prompt_tokens": t, "declined": d,
                 "alive": ok, "health": h}
                for a, t, d, ok, h in zip(self.assigned,
                                          self.assigned_tokens,
                                          self.declined, self.alive,
                                          self.health)],
        }


# ---------------------------------------------------------------------------
# health monitor (DESIGN.md §10 gray-failure watchdog)
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Gray-failure watchdog over an actor pool (DESIGN.md §10). Crashes
    announce themselves (a killed engine goes through `fail`); gray failures
    don't — a wedged engine keeps `running=True` and simply stops
    heartbeating, a degraded chip keeps completing ticks but slower. The
    monitor is a periodic observer stage that reads only what the stages
    already record (`last_tick_at` heartbeats, `ewma_tick_cost` progress)
    and routes every mitigation through existing machinery:

      hang       `now - last_tick_at` exceeds the per-engine deadline
                 `max(hang_grace, hang_factor * EWMA heartbeat gap)`
                 (preemption windows extend the deadline — a scheduled
                 offline engine is not a hang). Escalation: `on_hang`
                 runs the §8 fail/salvage/requeue path, exactly as if the
                 wedged process had been killed by an operator.
      straggler  speed-normalized progress `ewma_tick_cost * speed_i`
                 exceeds `straggler_factor` x the pool minimum for
                 `straggler_patience` consecutive sweeps. step_cost is
                 load-independent in the linear-utilization region, so
                 declared-slow engines normalize to the same statistic as
                 fast ones and never false-positive; a demoted engine
                 gets `PoolRouter.set_health(i, measured ratio)` — it
                 keeps decoding, the router just stops feeding it long
                 work — and is restored the first sweep it looks healthy.
      quarantine salvaged prompts carry a failure-attribution counter;
                 a prompt whose count crosses `quarantine_after` is
                 withheld from requeue (returned to the caller for
                 terminal accounting) instead of wedging engine after
                 engine. Attribution is per-prompt, not per-cause: a
                 prompt unlucky enough to sit on `quarantine_after`
                 genuinely-crashing engines is over-quarantined — the
                 blast-radius tradeoff is documented, counted, and
                 surfaced, never silent.

    The monitor reschedules itself only while some watched stage is
    `running and not failed` (a hung stage stays running, so it stays
    watched); `kick()` re-arms it when the pool comes back."""

    def __init__(self, loop: EventLoop, actors: Sequence[ActorStage], *,
                 router: Optional[PoolRouter] = None,
                 speeds: Optional[Sequence[float]] = None,
                 interval: float = 20.0,
                 hang_grace: float = 120.0, hang_factor: float = 8.0,
                 straggler_factor: float = 2.5,
                 straggler_patience: int = 2,
                 quarantine_after: int = 3,
                 on_hang: Optional[Callable[[int, float], None]] = None):
        self.loop, self.actors = _weakly(loop), list(actors)
        self.router = router
        self.speeds = ([float(s) for s in speeds] if speeds is not None
                       else [1.0] * len(self.actors))
        self.interval = float(interval)
        self.hang_grace = float(hang_grace)
        self.hang_factor = float(hang_factor)
        self.straggler_factor = float(straggler_factor)
        self.straggler_patience = int(straggler_patience)
        self.quarantine_after = int(quarantine_after)
        self.on_hang = on_hang
        n = len(self.actors)
        self._hb_seen: List[Optional[float]] = [None] * n
        self._watch_since: List[float] = [0.0] * n
        self._gap_ewma: List[Optional[float]] = [None] * n
        self._slow_streak: List[int] = [0] * n
        self._demoted: List[bool] = [False] * n
        self._armed = False
        # accounting (read by pipeline stats / benches / tests)
        self.sweeps = 0
        self.hangs_detected: List[Tuple[int, float, float]] = []
        #   (engine, detected_at, latency since last heartbeat)
        self.stragglers_demoted = 0
        self.stragglers_restored = 0
        self.prompts_quarantined = 0
        self.quarantined: List[Any] = []

    _GAP_ALPHA = 0.25

    # ---- lifecycle -----------------------------------------------------
    def watch_engine(self, speed: float = 1.0) -> None:
        """Track an engine appended to the pool (elastic join)."""
        self.speeds.append(float(speed))
        self._hb_seen.append(None)
        self._watch_since.append(self.loop.now)
        self._gap_ewma.append(None)
        self._slow_streak.append(0)
        self._demoted.append(False)

    def start(self, t: float) -> None:
        if not self._armed:
            self._armed = True
            for i in range(len(self.actors)):
                self._watch_since[i] = t
            self.loop.post(t + self.interval, self._sweep)

    def kick(self, now: float) -> None:
        """Re-arm after the pool went quiet (e.g. every engine was down
        and one restored): monitoring resumes with fresh deadlines."""
        if self._armed:
            return
        if any(a.running and not a.failed for a in self.actors):
            self._armed = True
            for i, a in enumerate(self.actors):
                self._watch_since[i] = now
            self.loop.post(now + self.interval, self._sweep)

    def notice_restore(self, i: int, now: float) -> None:
        """Reset engine `i`'s hang clock on restore: its last heartbeat
        predates the outage, so without this a long `restart_after` would
        read as an instant re-hang."""
        self._hb_seen[i] = None
        self._gap_ewma[i] = None
        self._watch_since[i] = now
        self._slow_streak[i] = 0
        self._demoted[i] = False   # router health was reset by the caller
        self.kick(now)

    # ---- the periodic sweep -------------------------------------------
    def _sweep(self, now: float) -> None:
        self.sweeps += 1
        self._check_hangs(now)
        self._check_stragglers(now)
        if any(a.running and not a.failed for a in self.actors):
            self.loop.post(now + self.interval, self._sweep)
        else:
            # nothing left to watch: disarm so a dead pool drains the
            # loop instead of spinning to max_events. `kick()` re-arms.
            self._armed = False

    def _deadline(self, i: int) -> float:
        gap = self._gap_ewma[i]
        if gap is None:
            return self.hang_grace
        return max(self.hang_grace, self.hang_factor * gap)

    def _check_hangs(self, now: float) -> None:
        for i, a in enumerate(self.actors):
            if not a.running or a.failed:
                self._hb_seen[i] = None
                continue
            hb = a.last_tick_at
            if hb is not None and hb != self._hb_seen[i]:
                if self._hb_seen[i] is not None and hb > self._hb_seen[i]:
                    gap = hb - self._hb_seen[i]
                    self._gap_ewma[i] = gap if self._gap_ewma[i] is None \
                        else (self._GAP_ALPHA * gap
                              + (1 - self._GAP_ALPHA) * self._gap_ewma[i])
                self._hb_seen[i] = hb
            # a scheduled preemption window is not a hang: while inside
            # one (read-only scan — no state change on the healthy path)
            # the heartbeat clock effectively restarts at the window end
            base = max((hb if hb is not None else self._watch_since[i]),
                       self._watch_since[i])
            for s, e in a._preempt:
                if s <= base:
                    base = max(base, e)
            if now - base > self._deadline(i):
                self.hangs_detected.append((i, now, now - base))
                if self.on_hang is not None:
                    self.on_hang(i, now)
                self._hb_seen[i] = None
                self._gap_ewma[i] = None
                self._watch_since[i] = now

    def _check_stragglers(self, now: float) -> None:
        if self.router is None:
            return
        norm: Dict[int, float] = {}
        for i, a in enumerate(self.actors):
            if a.failed or a.ewma_tick_cost is None:
                continue
            norm[i] = a.ewma_tick_cost * self.speeds[i]
        if len(norm) < 2:
            return   # no pool baseline to compare against
        floor = min(norm.values())
        if floor <= 0.0:
            return
        for i, v in norm.items():
            if v > self.straggler_factor * floor:
                self._slow_streak[i] += 1
                if self._slow_streak[i] >= self.straggler_patience:
                    health = max(floor / v, 0.05)
                    self.router.set_health(i, health)
                    if not self._demoted[i]:
                        self._demoted[i] = True
                        self.stragglers_demoted += 1
            else:
                self._slow_streak[i] = 0
                if self._demoted[i]:
                    self._demoted[i] = False
                    self.router.set_health(i, 1.0)
                    self.stragglers_restored += 1

    # ---- quarantine attribution ---------------------------------------
    def attribute_failure(self, salvaged: Sequence[Any]
                          ) -> Tuple[List[Any], List[Any]]:
        """Charge one failure attribution to each salvaged prompt and
        split them into (requeue, quarantine): prompts whose attribution
        count crossed `quarantine_after` are withheld from the pool (the
        §10 poison-prompt circuit breaker). The caller requeues the first
        list and surfaces the second as terminally failed."""
        requeue, quarantine = [], []
        for p in salvaged:
            count = getattr(p, "_fail_count", 0) + 1
            p._fail_count = count
            if count >= self.quarantine_after:
                quarantine.append(p)
            else:
                requeue.append(p)
        self.prompts_quarantined += len(quarantine)
        self.quarantined.extend(quarantine)
        return requeue, quarantine

    def stats(self) -> Dict[str, Any]:
        return {
            "sweeps": self.sweeps,
            "hangs_detected": len(self.hangs_detected),
            "hang_detect_latency": [lat for _, _, lat in
                                    self.hangs_detected],
            "stragglers_demoted": self.stragglers_demoted,
            "stragglers_restored": self.stragglers_restored,
            "prompts_quarantined": self.prompts_quarantined,
            "health": (list(self.router.health)
                       if self.router is not None else []),
        }


# ---------------------------------------------------------------------------
# preprocessor stage (paper Fig. 4 middle stage, overlapped)
# ---------------------------------------------------------------------------

class PreprocessStage:
    """Pulls B rollouts from the SampleQueue when both it and the trainer
    inbox are free, holds them for `preprocessor.stage_time`, then submits
    the processed batch to the trainer. Runs concurrently with both
    neighbors — while batch k preprocesses, the actors generate k+1 and
    the trainer trains k-1 — instead of adding its latency to the trainer
    tick. At most one batch is in flight and one may wait in the trainer
    inbox, so a trainer stall backs pressure up into the SampleQueue
    (drop-oldest) rather than into an unbounded inbox."""

    def __init__(self, loop: EventLoop, preprocessor, queue, batch_size: int,
                 trainer_stage: "TrainerStage"):
        self.loop, self.pre, self.queue = _weakly(loop), preprocessor, queue
        self.batch_size = batch_size
        self.trainer_stage = trainer_stage
        self.busy = False
        self.busy_until = 0.0
        self.batches = 0

    def kick(self, now: float) -> None:
        if self.busy or len(self.queue) < self.batch_size:
            return
        # overlap contract: preprocess batch k+1 while the trainer runs
        # batch k, but never queue a second *finished* batch at the
        # trainer — that's where back-pressure must fold back into the
        # SampleQueue (a busy trainer alone does not block us)
        if self.trainer_stage.inbox_waiting() > 0:
            return
        rollouts = self.queue.pop(self.batch_size)
        raw_reward = float(np.mean([r.reward for r in rollouts]))
        t_avail = max((r.finished_at for r in rollouts), default=now)
        processed = self.pre.process(rollouts)
        start = max(now, t_avail, self.busy_until)
        done = start + self.pre.stage_time(
            sum(r.length for r in processed))
        self.busy, self.busy_until = True, done
        self.batches += 1

        def _deliver(t: float) -> None:
            self.busy = False
            self.trainer_stage.submit(processed, t, raw_reward=raw_reward)
            self.kick(t)

        self.loop.post(done, _deliver)


# ---------------------------------------------------------------------------
# trainer stage
# ---------------------------------------------------------------------------

class TrainerStage:
    """Wraps a `Trainer` on the event loop: consumes batches from an inbox
    (fed by `submit`) or by pulling B rollouts from `queue` when idle,
    runs the real optimizer step eagerly, stamps completion on the
    simulated clock, publishes weights via the broadcaster, and models
    checkpoint stalls (`ckpt_every`/`ckpt_pause` — the scenario the
    SampleQueue's drop-oldest policy exists for).

    When `ckpt_dir` is given, the stall is no longer just a pause: each
    checkpoint step atomically persists the full TrainState to
    `<ckpt_dir>/trainer_latest.npz` plus a rotated, checksummed
    `trainer_step_<v>.npz` (last `ckpt_keep` kept).

    Numerical robustness (DESIGN.md §10): when the wrapped trainer runs
    with its non-finite guard, a non-finite step is skipped inside the
    step (state and version untouched) and counted here; the optional
    EWMA loss-spike detector (`loss_spike_factor` > 0) flags silently
    diverging steps the same way; `bad_step_rollback` consecutive bad
    steps restore the newest INTACT checkpoint (corrupt or truncated
    files are skipped through the content checksum). Trainer crash and
    restart come with the fault injection (ROADMAP.md queue A.7)."""

    def __init__(self, loop: EventLoop, trainer, *, queue=None,
                 batch_size: int = 0,
                 train_time: Callable[[int], float] = lambda n: 0.0,
                 pack_rows: int = 8, pack_seq: int = 128,
                 log: Optional[List[Dict]] = None,
                 broadcaster: Optional["WeightBroadcaster"] = None,
                 update_every: int = 1, group_baseline: bool = False,
                 ckpt_every: int = 0, ckpt_pause: float = 0.0,
                 ckpt_dir: Optional[str] = None, ckpt_keep: int = 3,
                 bad_step_rollback: int = 3,
                 loss_spike_factor: float = 0.0,
                 samples_per_step: Optional[int] = None,
                 on_free: Optional[Callable[[float], None]] = None,
                 max_lag: Optional[int] = None):
        self.loop, self.trainer = _weakly(loop), trainer
        self.queue, self.batch_size = queue, batch_size
        self.train_time = train_time
        self.pack_rows, self.pack_seq = pack_rows, pack_seq
        self.log = log if log is not None else []
        self.broadcaster = broadcaster
        self.update_every = max(int(update_every), 1)
        self.group_baseline = group_baseline
        self.ckpt_every, self.ckpt_pause = ckpt_every, ckpt_pause
        self.samples_per_step = samples_per_step or batch_size
        self.on_free = on_free
        self.busy = False
        self.free_at = 0.0
        self.stalls = 0
        self._inbox: deque = deque()   # (rollouts, raw_reward, avail, on_done)
        # crash-restart checkpointing (DESIGN.md §8)
        self.ckpt_dir = ckpt_dir
        self.ckpt_keep = max(int(ckpt_keep), 1)
        self.ckpt_path: Optional[str] = None
        self.ckpts_saved = 0
        self.last_ckpt_version = 0
        self._rotated: List[str] = []   # rotated ckpt paths, oldest first
        # numerical robustness (DESIGN.md §10)
        self.bad_step_rollback = int(bad_step_rollback)
        self.loss_spike_factor = float(loss_spike_factor)
        self.bad_steps = 0             # guard skips + divergence flags
        self.divergences = 0           # loss-spike detector hits alone
        self.consecutive_bad = 0
        self.rollbacks = 0
        self.ckpts_corrupt = 0         # skipped by the intact-fallback
        self._loss_ewma: Optional[float] = None
        # staleness contract (DESIGN.md §12): every packed batch carries
        # per-token lag vs the version this stage steps FROM; max_lag
        # additionally hard-masks over-bound tokens out of the loss
        self.max_lag = max_lag
        self.lag_hist: Dict[int, int] = {}   # lag -> trained-token count
        self.lag_masked_tokens = 0           # tokens dropped by the bound
        if ckpt_dir is not None:
            # version-0 seed checkpoint: a crash before the first periodic
            # save must still have something durable to restore from
            self.ckpt_path = self._save_ckpt(0)

    _LOSS_ALPHA = 0.2                  # loss-spike EWMA smoothing

    # ---- checkpoint rotation (DESIGN.md §10) --------------------------
    def _save_ckpt(self, version: int) -> str:
        """Persist the TrainState to `trainer_latest.npz` AND a rotated
        `trainer_step_<version>.npz`, keeping the newest `ckpt_keep`
        rotated files — the NaN-rollback path always has more than one
        restore target, so one corrupt/truncated file cannot strand it."""
        rotated = self.trainer.save(
            os.path.join(self.ckpt_dir, f"trainer_step_{version:06d}"))
        if rotated in self._rotated:    # re-save of the same version
            self._rotated.remove(rotated)
        self._rotated.append(rotated)
        while len(self._rotated) > self.ckpt_keep:
            old = self._rotated.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass
        path = self.trainer.save(
            os.path.join(self.ckpt_dir, "trainer_latest"))
        self.ckpts_saved += 1
        return path

    def restore_newest_intact(self) -> Optional[str]:
        """Restore the TrainState from the newest checkpoint that passes
        integrity verification (`trainer_latest` first, then the rotated
        files newest-to-oldest). Corrupt, truncated or unreadable files
        are counted (`ckpts_corrupt`) and skipped. Returns the path
        restored from, or None when no intact checkpoint exists (the
        state is left untouched)."""
        from repro_torch.checkpoint.checkpoint import CheckpointError
        seen = set()
        candidates = []
        for p in ([self.ckpt_path] if self.ckpt_path else []) + \
                list(reversed(self._rotated)):
            if p not in seen:
                seen.add(p)
                candidates.append(p)
        for path in candidates:
            try:
                self.trainer.restore(path)
                return path
            except CheckpointError:
                self.ckpts_corrupt += 1
        return None

    def inbox_waiting(self) -> int:
        """Batches delivered but not yet started (excludes the running
        step) — the quantity the preprocessor's run-ahead bound is on."""
        return len(self._inbox)

    def submit(self, rollouts: List[Rollout], now: float,
               raw_reward: Optional[float] = None,
               on_done: Optional[Callable[[float], None]] = None) -> None:
        avail = max((r.finished_at for r in rollouts), default=now)
        self._inbox.append((rollouts, raw_reward, avail, on_done))
        self.kick(now)

    def kick(self, now: float) -> None:
        if self.busy:
            return
        if self._inbox:
            rollouts, raw_reward, avail, on_done = self._inbox.popleft()
        elif (self.queue is not None and self.batch_size
                and len(self.queue) >= self.batch_size):
            rollouts = self.queue.pop(self.batch_size)
            raw_reward, on_done = None, None
            avail = max((r.finished_at for r in rollouts), default=now)
        else:
            return
        self._train(rollouts, raw_reward, avail, now, on_done)

    def _train(self, rollouts, raw_reward, avail, now, on_done) -> None:
        start = max(now, self.free_at, avail)
        if raw_reward is None:
            raw_reward = float(np.mean([r.reward for r in rollouts]))
        queue_depth = len(self.queue) if self.queue is not None else 0
        if self.group_baseline:
            rollouts = apply_group_baseline(rollouts)
        # staleness is computed against the version the learner steps
        # FROM (pre-step `trainer.version`), typed into the batch by
        # pack() — not recomputed ad hoc from the rollouts afterwards
        pre_version = self.trainer.version
        batch = pack(rollouts, self.pack_rows, self.pack_seq,
                     trainer_version=pre_version, max_lag=self.max_lag)
        stats = batch.pop("packing_stats")
        trained = batch["loss_mask"] > 0
        lag_vals = batch["lag"][trained]
        max_lag = float(lag_vals.max()) if lag_vals.size else 0.0
        mean_lag = float(lag_vals.mean()) if lag_vals.size else 0.0
        for v, c in zip(*np.unique(lag_vals, return_counts=True)):
            self.lag_hist[int(v)] = self.lag_hist.get(int(v), 0) + int(c)
        self.lag_masked_tokens += int(stats.get("lag_masked", 0))
        # the host batch goes straight in: the trainer stages it; returned
        # metrics stay on the device until the log entry below reads them
        metrics = self.trainer.step(batch)
        # §10 bad-step policy: a non-finite step was already dropped
        # inside the step (skip-and-count — state and version are
        # untouched); the optional loss-spike detector flags silent
        # divergence. Either way the step consumed its batch and its
        # wall-time, and `consecutive_bad` arms the rollback.
        bad = bool(getattr(self.trainer, "guard", False)) \
            and self.trainer.last_nonfinite()
        if not bad and self.loss_spike_factor > 0.0:
            loss = (metrics.peek("loss") if hasattr(metrics, "peek")
                    else float(metrics["loss"]))
            if self._loss_ewma is not None and \
                    abs(loss) > self.loss_spike_factor * \
                    max(abs(self._loss_ewma), 1e-8):
                bad = True
                self.divergences += 1
            else:
                self._loss_ewma = loss if self._loss_ewma is None else (
                    self._LOSS_ALPHA * loss
                    + (1.0 - self._LOSS_ALPHA) * self._loss_ewma)
        if bad:
            self.bad_steps += 1
            self.consecutive_bad += 1
        else:
            self.consecutive_bad = 0
        n_tokens = sum(r.length for r in rollouts)
        done = start + self.train_time(n_tokens)
        version = self.trainer.version
        stall = 0.0
        do_ckpt = bool(self.ckpt_every and not bad
                       and version % self.ckpt_every == 0)
        if do_ckpt:
            stall = self.ckpt_pause
            done += stall
            self.stalls += 1
        self.busy, self.free_at = True, done
        entry = {
            "version": version,
            "samples": version * self.samples_per_step,
            "time": done,
            "reward": raw_reward,
            "mean_len": float(np.mean([r.length for r in rollouts])),
            "max_lag": max_lag,
            "mean_lag": mean_lag,
            "fill": stats["fill"],
            "queue_depth": queue_depth,
            "stall": stall,
            "bad_step": float(bad),
            **metrics,
        }
        if self.max_lag is not None:
            entry["lag_masked"] = int(stats.get("lag_masked", 0))
        self.log.append(entry)

        def _finish(t: float) -> None:
            self.busy = False
            # the checkpoint becomes durable when the step that produced
            # it completes
            if do_ckpt and self.ckpt_dir is not None:
                self.ckpt_path = self._save_ckpt(version)
                self.last_ckpt_version = version
            # a bad step never publishes: its version did not advance,
            # and re-broadcasting the previous weights would only burn
            # interconnect and pause decode for nothing
            if not bad and self.broadcaster is not None and \
                    version % self.update_every == 0:
                self.broadcaster.publish(self.trainer.params, version, t)
            if bad and self.ckpt_dir is not None \
                    and self.bad_step_rollback > 0 \
                    and self.consecutive_bad >= self.bad_step_rollback:
                # divergence circuit breaker: rewind to the newest intact
                # checkpoint (corrupt files are skipped) and start clean
                if self.restore_newest_intact() is not None:
                    self.rollbacks += 1
                    self.consecutive_bad = 0
                    self.free_at = max(self.free_at, t + self.ckpt_pause)
            if on_done is not None:
                on_done(t)
            self.kick(t)
            if self.on_free is not None:
                self.on_free(t)

        self.loop.post(done, _finish)


# ---------------------------------------------------------------------------
# weight broadcaster
# ---------------------------------------------------------------------------

class WeightBroadcaster:
    """Publication path from the trainer to an actor pool. The transfer is
    serialized over the trainer's egress interconnect (unicast chain), so
    engine i's data lands after engine i-1's: the pool's staggered
    weight-arrival times fall out of the cost model.

    mode:
      "free"     zero-cost instant swap (an ablation upper bound)
      "atomic"   whole-tree transfer, engine pauses `broadcast_time`
                 for it (the naive load_weights-style update)
      "streamed" layer-chunked transfer overlapped with decode: chunks
                 arrive every `broadcast_time/n_chunks`; the engine only
                 pauses `bcast_install_flash` per installed chunk and
                 pointer-swaps on the last (the paper's "brief pause")

    Actors whose stage has `failed` set are skipped (a rejoining engine
    gets a catch-up atomic sync before admission). Every streamed chunk
    carries its checksum token and the publication its digest, which the
    engine verifies. The lossy link of the fault injection is not ported
    (ROADMAP.md queue A.7)."""

    def __init__(self, hw, actors: Sequence[ActorStage],
                 mode: str = "streamed", n_chunks: int = 8):
        if mode not in ("free", "atomic", "streamed"):
            raise ValueError(f"unknown broadcast mode {mode!r}")
        self.hw, self.actors, self.mode = hw, list(actors), mode
        self.n_chunks = max(int(n_chunks), 1)
        self.published = 0
        self.bytes_published = 0
        self.deliveries_skipped = 0

    def publish(self, params, version: int, now: float) -> None:
        self.published += 1
        targets = [a for a in self.actors if not getattr(a, "failed", False)]
        self.deliveries_skipped += len(self.actors) - len(targets)
        nbytes = tree_bytes(params)
        self.bytes_published += nbytes * len(targets)
        if self.mode == "free":
            for a in targets:
                a.deliver_atomic(now, params, version, pause=0.0)
            return
        t_full = self.hw.broadcast_time(nbytes)
        if self.mode == "atomic":
            for j, a in enumerate(targets):
                a.deliver_atomic(now + (j + 1) * t_full, params, version,
                                 pause=t_full)
            return
        t_chunk = t_full / self.n_chunks
        # integrity gate: per-chunk checksum tokens and the publication
        # digest, computed from the same deterministic span table the
        # engines derive on their own
        leaves = tree_flatten(params)[0]
        sizes = span_bytes(leaves, chunk_spans(leaves, self.n_chunks))
        good = [chunk_token(version, k, sizes[k]) for k in range(len(sizes))]
        digest = stream_digest(good)
        for j, a in enumerate(targets):
            base = now + j * t_full
            arrivals = [base + (k + 1) * t_chunk
                        for k in range(self.n_chunks)]
            tokens = [good[k] if k < len(good) else None
                      for k in range(self.n_chunks)]
            a.deliver_stream(params, version, arrivals,
                             install_pause=self.hw.bcast_install_flash,
                             tokens=tokens, n_chunks=self.n_chunks,
                             digest=digest)

    def stats(self) -> Dict[str, Any]:
        per_engine = []
        for a in self.actors:
            per_engine.append({
                "name": a.name,
                "updates_applied": a.updates_applied,
                "streams_completed": a.streams_completed,
                "streams_aborted": a.streams_aborted,
                "wchunks_rejected": getattr(a.engine, "wchunks_rejected", 0),
                "wstreams_torn": getattr(a.engine, "wstreams_torn", 0),
                "pause_total": a.pause_total,
                "pause_per_update": (a.pause_total / a.updates_applied
                                     if a.updates_applied else 0.0),
            })
        return {
            "mode": self.mode,
            "published": self.published,
            "bytes_published": self.bytes_published,
            "deliveries_skipped": self.deliveries_skipped,
            "engines": per_engine,
        }
