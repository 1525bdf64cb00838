"""Learning-rate schedules as functions of the 0-d step tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32, device=step.device)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_ratio: float = 0.1):
    def fn(step):
        step = step.float()
        warm = lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * (final_ratio + (1 - final_ratio)
                    * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def warmup_constant(lr: float, warmup_steps: int):
    def fn(step):
        step = step.float()
        return lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    return fn
