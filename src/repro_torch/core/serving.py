"""Request-level serving front over the continuous-batching engine. A port
of the JAX package's `core/serving.py`.

Mirrors the paper's three integration endpoints (§4 "Architecture and
Implementation Details") in-process:

  - submit()/step()            ~ /v1/chat/completions (batched, continuous)
  - connect_trainer()          ~ /init_process_group (weight-transfer pairing)
  - request_weight_update()    ~ /request_weight_update (in-flight update)

The server is a configuration of the shared event-driven substrate
(`core/events.py`): one externally-driven `ActorStage` (`chain=False` —
each `step(dt)` posts exactly one admission+decode tick onto the
`EventLoop`) with a step-denominated cost model (`dt` per decode step,
`dt` per chunked-prefill invocation) instead of the RL orchestrators'
flash-unit HardwareModel closures.

Tracks per-request latency (admission wait, end-to-end) so serving SLOs
are measurable across in-flight updates — the paper's headline property:
the engine only *briefly pauses* for new weights, no request is dropped.
Graceful degradation under faults (DESIGN.md §8): waiting requests carry
admission `deadline`s; a miss re-submits with capped exponential backoff
(up to `max_retries`, then a final reject), and `queue_limit` sheds new
submissions at the door when the waiting queue is saturated. Every
submitted request ends in exactly one of {done, in_flight, waiting,
backoff-held, rejected, shed, quarantined} —
`metrics()["requests_lost"]` asserts that accounting is airtight (always
0). Admission is policy-driven (`admission="fifo"|"sjf"` — shortest
prompt first), and prompts longer than the engine's budget fail fast: the
request comes back `rejected=True` (counted in
`metrics()["prompts_rejected"]`). `request_weight_update(streamed=True)`
exercises the chunked publication path: the new weights install one chunk
per serving step and the policy version flips only at the final pointer
swap.

Ownership runs one way, as in `core/events.py`: the Server holds its loop,
engine and stage; the engine's prompt source, its rejection callback, the
stage's delivery callback and cost closures refer back to the Server
weakly. A dropped Server frees its engine's cache by reference counting.
"""
from __future__ import annotations

import dataclasses
import heapq
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.events import ActorStage, EventLoop, weak_method
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.data.math_task import Problem
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    submitted_at: float = 0.0    # latest (re-)submission time
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    completion_ids: Optional[np.ndarray] = None
    weight_versions: Optional[np.ndarray] = None
    rejected: bool = False      # prompt over budget OR retries exhausted
    # graceful degradation (DESIGN.md §8)
    first_submitted_at: float = 0.0   # latency anchors here, so retry
    #                                   backoff time counts against SLO
    deadline: Optional[float] = None  # admission deadline (absolute)
    retries: int = 0
    shed: bool = False          # refused at the door (queue_limit)
    quarantined: bool = False   # §10 circuit breaker tripped
    fail_reason: Optional[str] = None

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.first_submitted_at


class _QueueSource:
    """Prompt source draining the server's waiting queue (None when empty);
    records which Request each admitted Problem belongs to. `admission`
    orders the drain: "fifo" (submission order) or "sjf" (shortest prompt
    first; ties break by submission order, so it stays deterministic and
    starvation shows up as admission wait, not nondeterminism). Holds its
    server weakly: the server owns the engine that owns this source."""

    def __init__(self, server: "Server", admission: str = "fifo"):
        if admission not in ("fifo", "sjf"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.server = weakref.proxy(server)
        self.admission = admission

    def __call__(self) -> Optional[Problem]:
        waiting = self.server.waiting
        if not waiting:
            return None
        if self.admission == "sjf":
            k = min(range(len(waiting)),
                    key=lambda i: (len(waiting[i].prompt_ids), i))
        else:
            k = 0
        req = waiting[k]
        # page-costed admission (DESIGN.md §9): a paged engine that cannot
        # back the candidate's KV blocks leaves it WAITING — its admission
        # deadline keeps ticking, so sustained page pressure degrades into
        # counted deadline misses/retries, never a hang or a silent drop
        if not self.server.engine.can_admit(len(req.prompt_ids)):
            self.server.admissions_deferred += 1
            return None
        del waiting[k]
        req.admitted_at = self.server.clock
        self.server.in_flight[req.rid] = req
        prob = Problem(req.prompt_ids, 0)
        prob.rid = req.rid  # type: ignore[attr-defined]
        return prob


class Server:
    """Continuous-batching server with in-flight weight updates. Builds its
    engine on `device`, the card unless the caller asks for the CPU;
    `params` must already live there."""

    def __init__(self, cfg: ModelConfig, params, ec: EngineConfig,
                 seed: int = 0, admission: str = "fifo",
                 deadline: Optional[float] = None, max_retries: int = 0,
                 retry_backoff: float = 4.0, backoff_cap: float = 64.0,
                 queue_limit: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg, self.ec = cfg, ec
        self.waiting: deque = deque()
        self.in_flight: Dict[int, Request] = {}
        self.done: List[Request] = []
        self.rejected: List[Request] = []
        self.shed: List[Request] = []
        self.quarantined: List[Request] = []
        # per-request admission deadline + retry/backoff + load shedding
        self.deadline = deadline
        self.max_retries = int(max_retries)
        self.retry_backoff = retry_backoff
        self.backoff_cap = backoff_cap
        self.queue_limit = queue_limit
        self.requests_retried = 0
        self.deadline_misses = 0
        self.admissions_deferred = 0  # paged: candidate left waiting for pages
        self._backoff: List[Tuple[float, int, Request]] = []  # heap
        self._bseq = 0
        self._next_rid = 0
        self._trainer: Optional[Callable] = None
        self._source = _QueueSource(self, admission=admission)
        self.engine = GenerationEngine(cfg, params, ec, self._source,
                                       seed=seed, device=self.device)
        self.engine.on_prompt_rejected = weak_method(self._reject)
        self.loop = EventLoop()
        self._dt = 1.0
        self._updates = 0
        self._completed_now: List[Request] = []
        me = weakref.proxy(self)
        self.actor = ActorStage(
            self.loop, self.engine, task=None, name="server",
            step_cost=lambda h: me._dt,
            prefill_cost=lambda toks, inv: me._dt * inv,
            deliver=weak_method(self._complete), auto_refill=True,
            refill_first=True, chain=False)

    @property
    def clock(self) -> float:
        return self.loop.now

    # ---- the three endpoints -----------------------------------------
    def submit(self, prompt_ids: List[int]) -> int:
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock
        req = Request(rid, list(prompt_ids), submitted_at=now,
                      first_submitted_at=now)
        if (self.queue_limit is not None
                and len(self.waiting) >= self.queue_limit):
            # load shedding: refuse at the door rather than letting the
            # waiting queue (and every deadline in it) blow out
            req.shed, req.rejected, req.finished_at = True, True, now
            self.shed.append(req)
            return rid
        if self.deadline is not None:
            req.deadline = now + self.deadline
        self.waiting.append(req)
        return rid

    def connect_trainer(self, get_weights: Callable[[], tuple]) -> None:
        """Pair with a trainer: `get_weights() -> (params, version)`."""
        self._trainer = get_weights

    def request_weight_update(self, recompute_kv: bool = False,
                              streamed: bool = False,
                              n_chunks: int = 8) -> int:
        """In-flight update. Atomic (default): swap weights at the next
        step boundary; every in-flight request keeps its KV cache.
        streamed=True: layer-chunked publication — one chunk installs per
        serving step (the shadow buffer fills between decode steps) and
        the version flips only at the final pointer swap."""
        assert self._trainer is not None, "connect_trainer first"
        params, version = self._trainer()
        self._updates += 1
        if streamed:
            # all chunks are "arrived"; the per_tick cap meters them out
            # one per step so the transfer overlaps serving
            self.actor.deliver_stream(params, version,
                                      arrivals=[self.clock] * n_chunks,
                                      install_pause=0.0, per_tick=1,
                                      recompute_kv=recompute_kv)
        else:
            self.engine.set_weights(params, version,
                                    recompute_kv=recompute_kv)
        return version

    def quarantine(self, rid: int, reason: str = "poison") -> bool:
        """Gray-failure circuit breaker (DESIGN.md §10): pull a request
        out of service into a counted terminal state with a reason — a
        prompt that repeatedly wedges whatever decodes it must stop
        consuming capacity, but it must never be silently dropped (the
        `requests_lost == 0` invariant covers quarantined requests). An
        in-flight request's decode slot is reclaimed via the engine's
        `kill_slot`; waiting/backoff-held requests are simply removed.
        Returns False if `rid` is unknown or already terminal."""
        now = self.clock
        req = self.in_flight.pop(rid, None)
        if req is not None:
            for s, prob in enumerate(self.engine.problems):
                if prob is not None and getattr(prob, "rid", None) == rid:
                    self.engine.kill_slot(s)
                    break
        else:
            for k, cand in enumerate(self.waiting):
                if cand.rid == rid:
                    req = cand
                    del self.waiting[k]
                    break
            else:
                for k, (_, _, cand) in enumerate(self._backoff):
                    if cand.rid == rid:
                        req = cand
                        del self._backoff[k]
                        heapq.heapify(self._backoff)
                        break
        if req is None:
            return False
        req.quarantined, req.rejected = True, True
        req.fail_reason = reason
        req.finished_at = now
        self.quarantined.append(req)
        return True

    # ---- serving loop ---------------------------------------------------
    def _reject(self, prob) -> None:
        """Engine declined the prompt (longer than max_len-2): fail the
        owning request immediately instead of leaving it in_flight
        forever — the caller sees `rejected=True`, not a hang."""
        rid = getattr(prob, "rid", None)
        req = self.in_flight.pop(rid, None)
        if req is None:
            return
        req.rejected = True
        req.finished_at = self.clock
        self.rejected.append(req)

    def _complete(self, rollouts, t: float) -> None:
        for r in rollouts:
            prob = self.engine.problems[r.slot]
            rid = getattr(prob, "rid", None)
            if rid is None or rid not in self.in_flight:
                continue
            req = self.in_flight.pop(rid)
            req.finished_at = t
            req.completion_ids = r.tokens[r.prompt_len:]
            req.weight_versions = r.weight_versions[r.prompt_len:]
            self.done.append(req)
            self._completed_now.append(req)
        # advance the clock to the tick completion even when nothing
        # finished (the tick event itself fires at the tick *start* time)
        self.loop.post(t, lambda now: None)

    def _sweep_deadlines(self, now: float) -> None:
        """Graceful degradation sweep, run before each admission tick:
        (1) requests whose backoff hold expired re-enter the waiting
        queue with a fresh deadline; (2) waiting requests past their
        deadline either retry — exponential backoff hold, capped at
        `backoff_cap` — or, with retries exhausted, reject for good.
        Deadlines only govern *admission*: once a request holds a decode
        slot it runs to completion."""
        while self._backoff and self._backoff[0][0] <= now:
            _, _, req = heapq.heappop(self._backoff)
            req.submitted_at = now
            if self.deadline is not None:
                req.deadline = now + self.deadline
            self.waiting.append(req)
        still: deque = deque()
        for req in self.waiting:
            if req.deadline is None or now <= req.deadline:
                still.append(req)
                continue
            self.deadline_misses += 1
            if req.retries < self.max_retries:
                req.retries += 1
                self.requests_retried += 1
                hold = min(self.retry_backoff * (2.0 ** (req.retries - 1)),
                           self.backoff_cap)
                heapq.heappush(self._backoff, (now + hold, self._bseq, req))
                self._bseq += 1
            else:
                req.rejected, req.finished_at = True, now
                self.rejected.append(req)
        self.waiting = still

    def step(self, dt: float = 1.0) -> List[Request]:
        """Admit waiting requests, decode one token for every in-flight
        request; returns requests completed this step. One call = one
        tick of the shared event scheduler."""
        self._dt = dt
        self._completed_now = []
        if (self.deadline is not None or self._backoff):
            self._sweep_deadlines(self.clock)
        self.loop.post(self.loop.now, self.actor.tick)
        self.loop.run()
        return self._completed_now

    # ---- metrics --------------------------------------------------------
    def metrics(self) -> dict:
        lat = [r.latency for r in self.done if r.latency is not None]
        wait = [r.admitted_at - r.submitted_at for r in self.done
                if r.admitted_at is not None]
        # retried requests' total time — backoff holds included, since
        # latency anchors at first_submitted_at (the SLO the client sees)
        rlat = [r.latency for r in self.done
                if r.retries and r.latency is not None]
        accounted = (len(self.done) + len(self.in_flight)
                     + len(self.waiting) + len(self._backoff)
                     + len(self.rejected) + len(self.shed)
                     + len(self.quarantined))
        return {
            "served": len(self.done),
            "in_flight": len(self.in_flight),
            "waiting": len(self.waiting),
            # graceful-degradation accounting (DESIGN.md §8)
            "requests_rejected": len(self.rejected),
            "requests_retried": self.requests_retried,
            "requests_shed": len(self.shed),
            "requests_quarantined": len(self.quarantined),
            "deadline_misses": self.deadline_misses,
            "admissions_deferred": self.admissions_deferred,
            "free_pages": (self.engine.free_pages
                           if self.engine._paged else None),
            "backoff_held": len(self._backoff),
            "requests_lost": self._next_rid - accounted,   # invariant: 0
            "retry_p50_latency": float(np.percentile(rlat, 50)) if rlat
            else 0.0,
            "retry_p99_latency": float(np.percentile(rlat, 99)) if rlat
            else 0.0,
            "p50_latency": float(np.percentile(lat, 50)) if lat else 0.0,
            "p99_latency": float(np.percentile(lat, 99)) if lat else 0.0,
            "mean_admission_wait": float(np.mean(wait)) if wait else 0.0,
            "tokens_generated": self.engine.tokens_generated,
            # chunked-prefill admission path (DESIGN.md §2)
            "prefill_tokens": self.engine.prefill_tokens,
            "prefill_invocations": self.engine.prefill_invocations,
            # long-prompt admission policy (EngineConfig.long_prompt)
            "prompts_rejected": self.engine.prompts_rejected,
            "prompts_truncated": self.engine.prompts_truncated,
            # weight-publication path (DESIGN.md §7)
            "weight_updates": self._updates,
            "streams_completed": self.actor.streams_completed,
            # per-request weight-lag over the completion's version stamps
            # (DESIGN.md §12): a request served across an in-flight update
            # mixes versions — lag here is each token's distance from the
            # newest version *within its own request* (0 for a request
            # served entirely under one version)
            **self._request_lag(),
        }

    def _request_lag(self) -> dict:
        means, maxes = [], []
        for r in self.done:
            vs = r.weight_versions
            if vs is None or len(vs) == 0:
                continue
            lag = vs.max() - vs
            means.append(float(lag.mean()))
            maxes.append(float(lag.max()))
        return {
            "request_lag_mean": float(np.mean(means)) if means else 0.0,
            "request_lag_max": float(np.max(maxes)) if maxes else 0.0,
            "requests_mixed_version": int(sum(1 for m in maxes if m > 0)),
        }
