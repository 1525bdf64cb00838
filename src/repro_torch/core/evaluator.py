"""Periodic greedy evaluation during RL training (the paper's MATH500/AIME
evals, at testbed scale): success rate over a fixed held-out problem set.
A port of the JAX package's `core/evaluator.py`."""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.data.math_task import MathTask, Problem
from repro_torch.device import resolve_device


class Evaluator:
    """Scores params on a fixed problem set at temperature 1e-4 on a slot
    engine. Builds the engine on `device`, the card unless the caller asks
    for the CPU; `evaluate`'s params must live there."""

    def __init__(self, cfg: ModelConfig, task: MathTask, n_problems: int = 32,
                 max_len: int = 16, seed: int = 1234, device="cuda"):
        self.device = resolve_device(device)
        self.cfg, self.task = cfg, task
        eval_task = MathTask(max_operand=task.max_operand, ops=task.ops,
                             seed=seed)
        self.problems: List[Problem] = eval_task.sample_batch(n_problems)
        self.max_len = max_len

    def evaluate(self, params) -> dict:
        probs = list(self.problems)
        it = iter(probs)

        def source():
            try:
                return next(it)
            except StopIteration:  # engine refills past the set; recycle
                return probs[0]

        ec = EngineConfig(n_slots=len(probs), max_len=self.max_len,
                          temperature=1e-4)  # ~greedy
        eng = GenerationEngine(self.cfg, params, ec, source, seed=0,
                               device=self.device)
        eng.refill()
        rollouts = []
        for _ in range(self.max_len + 2):
            rollouts.extend(eng.step(self.task))
            if eng.n_active == 0:
                break
        if not rollouts:
            return {"success_rate": 0.0, "mean_len": 0.0, "n": 0}
        succ = float(np.mean([r.reward > 0.5 for r in rollouts]))
        return {
            "success_rate": succ,
            "mean_len": float(np.mean([r.length - r.prompt_len
                                       for r in rollouts])),
            "n": len(rollouts),
        }
