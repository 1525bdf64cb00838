"""Conventional RL baseline (Algorithm 1): alternate full-fleet generation
of B*G sequences with G optimizer steps; the behavior policy lags the
current policy by up to G-1 steps. Same engine, same trainer, same
simulated clock — and, since DESIGN.md §7, the same event-driven
substrate as PipelineRL: the alternating schedule is expressed as an
`ActorStage` that drains without refilling (`on_drained` hands control to
the `TrainerStage`) and a trainer whose G-th completion restarts the
generation phase. Only the configuration differs, not the loop.

The phase-boundary weight sync is costed: the fleet sits idle for
`HardwareModel.broadcast_time` of the full param tree before every
generation phase (the conventional analogue of the in-flight broadcast
pause, charged to the same clock so the Fig. 5 comparison is fair). A port of
the JAX package's `core/conventional.py`. Its callbacks on the loop refer
back to it weakly (`weak_method`), so a dropped instance frees its engine
and trainer by reference counting."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.events import (ActorStage, EventLoop, TrainerStage,
                                     weak_method)
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.core.sim import HardwareModel
from repro_torch.core.trainer import Trainer
from repro_torch.core.weights import tree_bytes
from repro_torch.data.math_task import MathTask
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ConventionalConfig:
    batch_size: int = 16          # B per optimizer step
    g_steps: int = 4              # G optimizer steps per RL step
    n_opt_steps: int = 48
    n_chips: int = 8              # all chips generate, then all train
    pack_rows: int = 8
    pack_seq: int = 128


class ConventionalRL:
    """The baseline on the same engine, trainer and clock. Builds its
    Trainer (unless given one) and engine on `device`, the card unless the
    caller asks for the CPU."""

    def __init__(self, cfg: ModelConfig, params, task: MathTask,
                 ec: EngineConfig, cc: ConventionalConfig,
                 hw: HardwareModel = HardwareModel(),
                 trainer: Optional[Trainer] = None, seed: int = 0,
                 device="cuda"):
        device = resolve_device(device)
        if ec.n_slots < cc.batch_size * cc.g_steps:
            ec = dataclasses.replace(ec, n_slots=cc.batch_size * cc.g_steps)
        self.cfg, self.task, self.ec, self.cc, self.hw = cfg, task, ec, cc, hw
        self.trainer = trainer or Trainer(cfg, params, device=device)
        self.engine = GenerationEngine(cfg, self.trainer.params, ec,
                                       task.sample, seed=seed, device=device)
        self.log: List[Dict] = []
        self.loop = EventLoop()
        self._started = False
        self.trainer_stage = TrainerStage(
            self.loop, self.trainer,
            train_time=lambda n: hw.train_time(n, cc.n_chips),
            pack_rows=cc.pack_rows, pack_seq=cc.pack_seq, log=self.log,
            samples_per_step=cc.batch_size)
        self._rollouts: List = []
        self.actor = ActorStage(
            self.loop, self.engine, task=task, name="fleet",
            step_cost=lambda h: hw.step_cost(h / cc.n_chips),
            auto_refill=False,
            deliver=weak_method(self._collect),
            on_drained=weak_method(self._train_phase))

    @property
    def time(self) -> float:
        return self.loop.now

    # ----- phases (event callbacks, not a loop) -------------------------
    def _collect(self, rollouts, t: float) -> None:
        self._rollouts.extend(rollouts)

    def _generation_phase(self, now: float) -> None:
        """mu <- pi (the fleet idles for the weight transfer), then admit
        B*G prompts and drain them without refilling."""
        t = now + self.hw.broadcast_time(tree_bytes(self.trainer.params))
        self.engine.set_weights(self.trainer.params, self.trainer.version)
        self._rollouts = []
        self.engine.refill(t)
        # chunked-prefill admission is batched prefill FLOPs on the fleet
        # (the legacy forcing loop charges decode steps instead)
        t += self.hw.prefill_time(self.engine.last_admit_prefill_tokens,
                                  self.cc.n_chips)
        self.actor.start(t)

    def _train_phase(self, now: float) -> None:
        """Drained: G optimizer steps over a fixed shuffle of the phase's
        rollouts; the G-th completion starts the next generation phase."""
        cc = self.cc
        rollouts = self._rollouts
        order = np.random.RandomState(self.trainer.version).permutation(
            len(rollouts))
        for g in range(cc.g_steps):
            idx = order[g * cc.batch_size:(g + 1) * cc.batch_size]
            chunk = [rollouts[i] for i in idx]
            self.trainer_stage.submit(
                chunk, now,
                on_done=(weak_method(self._generation_phase)
                         if g == cc.g_steps - 1 else None))

    # ----- run ----------------------------------------------------------
    def run(self, n_opt_steps: Optional[int] = None) -> List[Dict]:
        n = n_opt_steps or self.cc.n_opt_steps
        if not self._started:
            self._started = True
            self.loop.post(self.loop.now,
                           weak_method(self._generation_phase))
        self.loop.run(until=lambda: self.trainer.version >= n)
        return self.log
