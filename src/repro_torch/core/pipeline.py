"""PipelineRL orchestrator (Algorithm 2): concurrent actor pool + Trainer
with in-flight weight updates, co-simulated deterministically on the
event loop of `core.events`. A port of the JAX package's `core/pipeline.py`.

Each of the pool's generation engines is an `ActorStage` with its own
clock and chip share; finished rollouts stream through the shared
`SampleQueue` (and, when configured, an overlapped `PreprocessStage`) into
the `TrainerStage`, and every `update_every`-th optimizer step publishes
weights through the `WeightBroadcaster` (atomic or streamed, costed).

All stages run real compute on the port's engines, Preprocessor and
Trainer; the clock is the Appendix-A hardware model (flashes), so the
schedule is the same on any device: the trainer step runs as soon as B
sequences exist, its completion is stamped on the simulated clock, and
each actor applies arrived weight publications at its next decode-step
boundary. Engines in one pool share the trainer's parameter tensors (the
trainer's Adam makes new tensors, never writing into them).

Ownership runs one way (`core/events.py`): `PipelineRL` holds the loop,
whose heap holds the stages, which hold the engines and the trainer. No
callback refers back to `PipelineRL` strongly, so a dropped pipeline frees
its device memory by reference counting.

Fault injection (`fault_plan`) and mesh placement (`mesh`, `rules`) are
not ported yet (ROADMAP.md queue A.7).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.configs.base import HealthConfig, ModelConfig
from repro_torch.core.events import (
    ActorStage, EventLoop, HealthMonitor, LagGate, PoolRouter,
    PreprocessStage, TrainerStage, WeightBroadcaster, weak_method,
)
from repro_torch.core.queues import SampleQueue
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.core.sim import HardwareModel
from repro_torch.core.trainer import Trainer
from repro_torch.data.math_task import MathTask
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int = 16          # B sequences per optimizer step
    n_opt_steps: int = 50
    n_chips: int = 8              # N
    train_chips: int = 4          # T; generation gets N-T
    pack_rows: int = 8
    pack_seq: int = 128
    queue_maxsize: Optional[int] = None
    recompute_kv: bool = False    # §5.1 ablation
    update_every: int = 1         # optimizer steps between weight pushes
    # GRPO-style group-relative baseline (Shao et al., 2024): subtract the
    # mean reward of same-prompt rollouts instead of (or on top of) the
    # learned value baseline. Use with a prompt source that repeats prompts.
    group_baseline: bool = False
    # --- actor pool + weight broadcast (DESIGN.md §7) -----------------
    n_engines: int = 1            # independent generation engines sharing
    #                               the N-T generation chips
    broadcast: str = "streamed"   # "streamed" | "atomic" | "free"
    broadcast_chunks: int = 8     # layer chunks per streamed publication
    # --- pool scheduling (DESIGN.md §7 "Pool scheduling") -------------
    # per-engine HardwareModel speed overrides (len == n_engines): a
    # heterogeneous pool of slow/fast chips. None = homogeneous (1.0).
    engine_speeds: Optional[Sequence[float]] = None
    router: str = "fifo"          # PoolRouter policy: "fifo" |
    #                               "shortest_queue" | "length_affinity"
    router_lookahead: int = 0     # pending-prompt buffer (0 = pool slots)
    router_slack: Optional[float] = None  # shortest_queue admission slack
    # --- periodic asynchrony (DESIGN.md §12) --------------------------
    # bounded-staleness barrier: None = free-running pipeline (the
    # paper's operating point); an int bounds every *trained* token's
    # weight lag — actors pause (preemption-window machinery) when a
    # newly sampled token would exceed the bound, and pack() hard-masks
    # any over-bound token out of the loss. max_lag=0 is conventional-RL
    # lockstep. Requires update_every == 1 (versions that never publish
    # would park the pool forever).
    max_lag: Optional[int] = None
    # --- trainer-stall scenario (checkpoint pause every k steps) ------
    ckpt_every: int = 0
    ckpt_pause: float = 0.0       # flashes the trainer stalls per ckpt
    # when set, the stall actually persists the TrainState (atomically)
    # to <ckpt_dir>/trainer_latest.npz, the bad-step rollback's target
    ckpt_dir: Optional[str] = None
    # --- gray-failure self-healing (DESIGN.md §10) --------------------
    # HealthMonitor watchdog (hang/straggler detection + quarantine) and
    # the trainer's NaN-skip / loss-spike / rollback policy. Enabled by
    # default: on a healthy run the watchdog only observes.
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)


class PipelineRL:
    """The paper's system: run with `.run()`, read `.log` for R(t)/R(S).
    Builds its Trainer (unless given one) and engines on `device`, the card
    unless the caller asks for the CPU."""

    def __init__(self, cfg: ModelConfig, params, task: MathTask,
                 ec: EngineConfig, pc: PipelineConfig,
                 hw: HardwareModel = HardwareModel(),
                 trainer: Optional[Trainer] = None, seed: int = 0,
                 preprocessor=None,
                 prompt_source: Optional[Callable] = None,
                 fault_plan=None, mesh=None, rules=None, device="cuda"):
        for name, arg in (("fault_plan", fault_plan), ("mesh", mesh),
                          ("rules", rules)):
            if arg is not None:
                raise NotImplementedError(
                    f"PipelineRL({name}=...): fault injection and mesh "
                    f"placement are not ported yet (ROADMAP.md queue A.7)")
        self.device = resolve_device(device)
        self.cfg, self.task, self.ec, self.pc, self.hw = cfg, task, ec, pc, hw
        self.trainer = trainer or Trainer(cfg, params, device=self.device)
        self.preprocessor = preprocessor  # paper Fig. 4 middle stage
        self.queue = SampleQueue(pc.queue_maxsize)
        self.log: List[Dict] = []
        self.loop = EventLoop()
        self.seed = seed
        # pool membership changes: joins, detaches, detected hangs, restores
        self.fault_log: List[Dict] = []

        # --- actor pool: n_engines independent engines, each with its own
        # clock and an equal share of the N-T generation chips. The shared
        # prompt source feeds the pool through a PoolRouter (fifo = the
        # pass-through pull); per-engine HardwareModel speed overrides make
        # the pool heterogeneous.
        n_eng = max(int(pc.n_engines), 1)
        chips_per_engine = self.gen_chips / n_eng
        speeds = ([float(s) for s in pc.engine_speeds]
                  if pc.engine_speeds is not None else [1.0] * n_eng)
        if len(speeds) != n_eng:
            raise ValueError(f"engine_speeds has {len(speeds)} entries "
                             f"for n_engines={n_eng}")
        self.engine_speeds = speeds
        loop = weakref.proxy(self.loop)
        self.router = PoolRouter(prompt_source or task.sample,
                                 policy=pc.router,
                                 lookahead=pc.router_lookahead,
                                 slack=pc.router_slack,
                                 clock=lambda: loop.now)
        # periodic-asynchrony gate: one pool-shared bounded-staleness
        # barrier, consulted by every actor tick
        self.lag_gate: Optional[LagGate] = None
        if pc.max_lag is not None:
            if pc.max_lag < 0:
                raise ValueError(f"max_lag must be >= 0, got {pc.max_lag}")
            if pc.update_every != 1:
                raise ValueError(
                    "max_lag requires update_every=1: unpublished versions "
                    "would strand gate-parked actors with no delivery to "
                    "wake on")
            trainer = self.trainer
            self.lag_gate = LagGate(pc.max_lag, lambda: trainer.version)
        self.engines: List[GenerationEngine] = [
            self._make_engine(i) for i in range(n_eng)]
        self.router.attach(self.engines, speeds)

        self.trainer_stage = TrainerStage(
            self.loop, self.trainer,
            queue=None if preprocessor is not None else self.queue,
            batch_size=pc.batch_size,
            train_time=lambda n: hw.train_time(n, pc.train_chips),
            pack_rows=pc.pack_rows, pack_seq=pc.pack_seq, log=self.log,
            update_every=pc.update_every, group_baseline=pc.group_baseline,
            ckpt_every=pc.ckpt_every, ckpt_pause=pc.ckpt_pause,
            ckpt_dir=pc.ckpt_dir, ckpt_keep=pc.health.ckpt_keep,
            bad_step_rollback=pc.health.bad_step_rollback,
            loss_spike_factor=pc.health.loss_spike_factor,
            samples_per_step=pc.batch_size, max_lag=pc.max_lag)
        self.pre_stage = None
        if preprocessor is not None:
            self.pre_stage = PreprocessStage(
                self.loop, preprocessor, self.queue, pc.batch_size,
                self.trainer_stage)
            self.trainer_stage.on_free = weak_method(self.pre_stage.kick)
        queue = self.queue
        kick = weak_method((self.pre_stage or self.trainer_stage).kick)

        def _deliver(rollouts, t):
            queue.put(rollouts)
            if rollouts:
                kick(t)

        self._deliver = _deliver
        self._chips_per_engine = chips_per_engine
        self.actors: List[ActorStage] = [
            self._make_actor(i, eng, speeds[i])
            for i, eng in enumerate(self.engines)]
        self.broadcaster = WeightBroadcaster(
            hw, self.actors, mode=pc.broadcast, n_chunks=pc.broadcast_chunks)
        self.trainer_stage.broadcaster = self.broadcaster
        # watchdog: hang and straggler detection over the pool; a detected
        # hang escalates through fail/salvage/requeue, and repeat-offender
        # prompts are quarantined
        self.monitor: Optional[HealthMonitor] = None
        hc = pc.health
        if hc.enabled:
            self.monitor = HealthMonitor(
                self.loop, self.actors, router=self.router, speeds=speeds,
                interval=hc.interval, hang_grace=hc.hang_grace,
                hang_factor=hc.hang_factor,
                straggler_factor=hc.straggler_factor,
                straggler_patience=hc.straggler_patience,
                quarantine_after=hc.quarantine_after,
                on_hang=weak_method(self._on_hang))

    def _make_engine(self, i: int) -> GenerationEngine:
        """Pool engine i, on the trainer's parameter tensors."""
        return GenerationEngine(self.cfg, self.trainer.params, self.ec,
                                self.router.source_for(i),
                                seed=self.seed + 1009 * i,
                                device=self.device)

    def _make_actor(self, i: int, eng: GenerationEngine,
                    speed: float) -> ActorStage:
        """One pool member. The chip share stays fixed at the *configured*
        pool size (gen_chips / pc.n_engines) — elastic joins add capacity
        rather than re-slicing the incumbents' chips, matching how spare
        capacity is attached in practice."""
        c = self._chips_per_engine
        m = self.hw.scaled(speed)
        return ActorStage(
            self.loop, eng, task=self.task, name=f"actor{i}",
            step_cost=lambda h: m.step_cost(h / max(c, 1e-9)),
            prefill_cost=lambda toks, inv: m.prefill_time(toks, max(c, 1)),
            page_cost=m.page_touch_time,
            deliver=self._deliver, recompute_kv=self.pc.recompute_kv,
            lag_gate=self.lag_gate)

    # ----- compatibility surface ---------------------------------------
    @property
    def engine(self) -> GenerationEngine:
        """First pool engine (the whole pool for n_engines=1)."""
        return self.engines[0]

    @property
    def gen_chips(self) -> int:
        return self.pc.n_chips - self.pc.train_chips

    @property
    def actor_time(self) -> float:
        return max(a.time for a in self.actors)

    @property
    def trainer_time(self) -> float:
        return self.trainer_stage.free_at

    def broadcast_stats(self) -> Dict:
        """Per-engine weight-publication accounting: updates applied,
        decode pause charged per update, streams completed/aborted."""
        return self.broadcaster.stats()

    def router_stats(self) -> Dict:
        """Per-engine admission accounting (PoolRouter): prompts assigned,
        prompt tokens routed, pulls declined."""
        st = self.router.stats()
        for eng_stats, actor, speed in zip(st["engines"], self.actors,
                                           self.engine_speeds):
            eng_stats["name"] = actor.name
            eng_stats["speed"] = speed
            eng_stats["preempt_total"] = actor.preempt_total
        return st

    def lag_stats(self) -> Dict:
        """Staleness accounting for the whole run, from the *typed* lag
        fields the trainer packed (DESIGN.md §12) — supersedes the old
        ad-hoc per-batch recomputation. `histogram` maps lag value ->
        trained-token count; `masked_tokens` counts completions the
        `max_lag` bound dropped from the loss; per-engine entries report
        how far each engine's installed weights trail the learner right
        now, plus the gate pauses it absorbed."""
        ts = self.trainer_stage
        hist = dict(sorted(ts.lag_hist.items()))
        total = sum(hist.values())
        mean = (sum(v * c for v, c in hist.items()) / total
                if total else 0.0)
        st: Dict = {
            "bound": self.pc.max_lag,
            "histogram": hist,
            "trained_tokens": total,
            "max_lag": max(hist) if hist else 0,
            "mean_lag": mean,
            "masked_tokens": ts.lag_masked_tokens,
            "engines": [{
                "name": a.name,
                "version": int(a.engine.version),
                "behind": self.trainer.version - int(a.engine.version),
                "oldest_inflight": a.engine.oldest_inflight_version(),
                "lag_pauses": a.lag_pauses,
                "lag_wait_total": a.lag_wait_total,
            } for a in self.actors],
        }
        if self.lag_gate is not None:
            st["gate"] = self.lag_gate.stats()
        return st

    # ----- elastic pool and hang recovery (DESIGN.md §8, §10) ----------
    def _requeue_salvaged(self, salvaged, t: float) -> int:
        """Route salvaged prompts back to the pool through the monitor's
        failure attribution (§10): repeat offenders are quarantined —
        surfaced in `pool_stats()` instead of crash-looping engine after
        engine. Without a monitor everything requeues (§8 behavior).
        Returns the number quarantined."""
        if not salvaged:
            return 0
        if self.monitor is not None:
            requeue, quarantine = self.monitor.attribute_failure(salvaged)
        else:
            requeue, quarantine = list(salvaged), []
        if requeue:
            self.router.requeue(requeue, now=t)
        return len(quarantine)

    def _on_hang(self, i: int, t: float) -> None:
        """Watchdog escalation: treat the wedged engine exactly like an
        operator-killed process — fail/salvage, attribute the failure to
        the stranded prompts (quarantining repeat offenders), requeue the
        rest to survivors, and schedule a restart after the health
        policy's `hang_restart_after`."""
        a = self.actors[i]
        if a.failed:
            return
        salvaged = a.fail(t)
        self.router.set_alive(i, False)
        n_quar = self._requeue_salvaged(salvaged, t)
        for j, other in enumerate(self.actors):
            if j != i and not other.failed:
                other.start(t)
        self.fault_log.append({
            "kind": "engine_hang_detected", "engine": i, "at": t,
            "prompts_salvaged": len(salvaged),
            "prompts_quarantined": n_quar})
        delay = self.pc.health.hang_restart_after
        if delay is not None:
            restore = weak_method(self.restore_engine)
            self.loop.post(t + float(delay),
                           lambda tt, i=i: restore(i, tt))

    def restore_engine(self, i: int, t: Optional[float] = None) -> None:
        """Bring a crashed engine back. Before re-admission it gets a
        catch-up *atomic* weight sync to the trainer's newest params, so
        its first post-restart rollouts carry the exact current version
        stamp — a rejoining engine never generates with stale weights."""
        t = self.loop.now if t is None else t
        a = self.actors[i]
        if not a.failed:
            return
        a.restore(t, params=self.trainer.params,
                  version=self.trainer.version)
        self.router.set_alive(i, True)
        self.router.set_health(i, 1.0)   # fresh process, clean slate
        if self.monitor is not None:
            self.monitor.notice_restore(i, t)
        self.fault_log.append({
            "kind": "engine_restore", "engine": i, "at": t,
            "version": self.trainer.version, "downtime": a.downtime})

    def add_engine(self, speed: float = 1.0,
                   at: Optional[float] = None) -> int:
        """Elastic join: attach one new engine to the pool at runtime.
        The joiner receives a catch-up atomic weight sync to the current
        params/version *before* admission, and only then starts pulling
        prompts from the router. Returns the new engine's pool index."""
        t = self.loop.now if at is None else at
        idx = len(self.engines)
        eng = self._make_engine(idx)
        self.engines.append(eng)
        self.engine_speeds.append(float(speed))
        self.router.add_engine(eng, speed)
        a = self._make_actor(idx, eng, speed)
        self.actors.append(a)
        self.broadcaster.actors.append(a)
        if self.monitor is not None:
            self.monitor.actors.append(a)
            self.monitor.watch_engine(speed)
        # catch-up sync before admission: version stamps stay exact
        eng.set_weights(self.trainer.params, self.trainer.version,
                        recompute_kv=self.pc.recompute_kv)
        a.updates_applied += 1
        a.start(t)
        self.fault_log.append({
            "kind": "engine_join", "engine": idx, "at": t,
            "version": self.trainer.version})
        return idx

    def detach_engine(self, i: int, at: Optional[float] = None) -> int:
        """Elastic shrink: administratively remove engine i. Its in-flight
        prompts are salvaged and requeued to the survivors (partial decode
        work is lost, same as a crash — there is no drain protocol); the
        slot stays in the pool lists (marked dead) so indices are stable.
        Returns the number of prompts salvaged."""
        t = self.loop.now if at is None else at
        a = self.actors[i]
        if a.failed:
            return 0
        salvaged = a.fail(t)
        self.router.set_alive(i, False)
        if salvaged:
            self.router.requeue(salvaged, now=t)
        for j, other in enumerate(self.actors):
            if j != i and not other.failed:
                other.start(t)
        self.fault_log.append({
            "kind": "engine_detach", "engine": i, "at": t,
            "prompts_salvaged": len(salvaged)})
        return len(salvaged)

    def pool_stats(self) -> Dict:
        """Recovery/elasticity accounting for the whole pool: per-engine
        failure counters layered onto router + broadcaster stats."""
        st = self.router_stats()
        for eng_stats, actor in zip(st["engines"], self.actors):
            eng_stats.update({
                "failures": actor.failures,
                "recoveries": actor.recoveries,
                "rollouts_lost": actor.rollouts_lost,
                "prompts_salvaged": actor.prompts_salvaged,
                "downtime": actor.downtime,
            })
        st["rollouts_lost"] = sum(a.rollouts_lost for a in self.actors)
        st["prompts_salvaged"] = sum(a.prompts_salvaged for a in self.actors)
        # §10 zero-lost invariant: every salvaged prompt is either back in
        # the pool or in the counted quarantine list, never dropped
        st["prompts_quarantined"] = (self.monitor.prompts_quarantined
                                     if self.monitor is not None else 0)
        st["trainer"] = {
            "ckpts_saved": self.trainer_stage.ckpts_saved,
            "last_ckpt_version": self.trainer_stage.last_ckpt_version,
            # numerical robustness (DESIGN.md §10)
            "bad_steps": self.trainer_stage.bad_steps,
            "divergences": self.trainer_stage.divergences,
            "rollbacks": self.trainer_stage.rollbacks,
            "ckpts_corrupt": self.trainer_stage.ckpts_corrupt,
            "nonfinite_steps": getattr(self.trainer, "nonfinite_steps", 0),
        }
        st["broadcast"] = {
            "deliveries_skipped": self.broadcaster.deliveries_skipped,
            "wchunks_rejected": sum(getattr(e, "wchunks_rejected", 0)
                                    for e in self.engines),
            "wstreams_torn": sum(getattr(e, "wstreams_torn", 0)
                                 for e in self.engines),
        }
        if self.monitor is not None:
            st["health"] = self.monitor.stats()
        st["fault_log"] = list(self.fault_log)
        return st

    # ----- run ----------------------------------------------------------
    def run(self, n_opt_steps: Optional[int] = None) -> List[Dict]:
        """Run until the trainer reaches `n_opt_steps` optimizer steps
        (absolute). Resumable: pending events survive between calls."""
        n = n_opt_steps or self.pc.n_opt_steps
        for a in self.actors:
            a.start(self.loop.now)
        if self.monitor is not None:
            self.monitor.start(self.loop.now)
        self.loop.run(until=lambda: self.trainer.version >= n)
        return self.log
