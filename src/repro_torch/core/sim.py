"""Appendix-A analytical throughput model ("flash" time units).

A *flash* is the theoretically smallest amortized time for one token
forward pass (Eq. 9). U(h) is the accelerator utilization at per-chip batch
h (paper Fig. 8: near-linear up to h~200-256, then saturating ~0.5 of peak
for generation-shaped matmuls). tau is the amortized training flashes per
token (from the paper's case study: r_conv_train = N/tau = 26.02 at N=128
=> tau ~ 4.92).

These closed forms reproduce the paper's Fig. 9 case study (PipelineRL up
to ~1.57x conventional at equal max lag) and provide the simulated clock
for the co-simulated RL experiments. A copy of the JAX package's
`core/sim.py`; the flash is a unit of the model, not a time measured on
any device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    u_max: float = 0.5   # generation-kernel utilization ceiling (Fig. 8)
    h_sat: int = 256     # batch where utilization saturates
    tau: float = 4.92    # training flashes per token (Appendix A.4)
    # per-engine chip-speed override (DESIGN.md §7 pool scheduling): a
    # `speed`x faster chip runs the same decode/prefill work in 1/speed
    # the wall-time. Only the generation-side terms scale — the trainer
    # fleet and the broadcast interconnect are separate hardware.
    speed: float = 1.0
    # amortized flashes per *prompt* token admitted via chunked prefill: a
    # batched many-token forward runs compute-bound like training, so it
    # costs ~1 flash/token (the Eq. 9 definition of a flash) instead of a
    # full decode step per token
    prefill_flash: float = 1.0
    # trainer -> generation-engine weight-broadcast interconnect, in bytes
    # moved per flash of wall-time (DESIGN.md §7). An *atomic* publication
    # stalls decode for the whole transfer; a *streamed* one overlaps the
    # transfer with decode and only pauses `bcast_install_flash` per
    # installed chunk (shadow-buffer fill + pointer publish).
    bcast_bytes_per_flash: float = 1e4
    bcast_install_flash: float = 1.0
    # paged-KV admission overhead (DESIGN.md §9): flashes charged per page
    # the refill actually allocated — allocator bookkeeping plus the block
    # table push. 0.0 by default so slot-array runs are cost-identical;
    # prefix-shared GRPO admission shows up as fewer pages charged (the
    # group's prefix pages are allocated once, forks cost nothing).
    page_touch_flash: float = 0.0

    def U(self, h):
        """Utilization at per-chip batch h (0 at h=0)."""
        h = np.asarray(h, np.float64)
        return self.u_max * np.minimum(h, self.h_sat) / self.h_sat

    def scaled(self, speed: float) -> "HardwareModel":
        """Per-engine override for heterogeneous actor pools: the returned
        model's decode/prefill costs are divided by `speed` (composes
        multiplicatively with any existing override)."""
        return dataclasses.replace(self, speed=self.speed * float(speed))

    def step_cost(self, h) -> float:
        """Wall-time (flashes) for one decode step at per-chip batch h:
        h tokens at utilization U(h) -> h/U(h); 0 if no work."""
        h = float(h)
        if h <= 0:
            return 0.0
        return h / float(self.U(max(h, 1e-9))) / self.speed

    def train_time(self, n_tokens: int, n_chips: int) -> float:
        return n_tokens * self.tau / max(n_chips, 1)

    def prefill_time(self, n_tokens: int, n_chips: int) -> float:
        """Wall-time (flashes) to admit `n_tokens` prompt tokens through
        the batched chunked-prefill path. Costed as compute-bound prefill
        FLOPs — NOT as `prompt_len` decode steps of the whole H batch,
        which is what the legacy forcing loop effectively charged."""
        if n_tokens <= 0:
            return 0.0
        return n_tokens * self.prefill_flash / max(n_chips, 1) / self.speed

    def page_touch_time(self, n_pages: int) -> float:
        """Wall-time (flashes) for a refill that allocated `n_pages` KV
        pages (paged engines only; slot-array refills report 0 pages)."""
        if n_pages <= 0:
            return 0.0
        return n_pages * self.page_touch_flash / self.speed

    def broadcast_time(self, n_bytes: float) -> float:
        """Wall-time (flashes) to move `n_bytes` of weights over the
        trainer->engine interconnect (one unicast hop). Atomic updates
        charge this whole window as decode pause; streamed updates overlap
        it with decode and pause only per-chunk installs (DESIGN.md §7)."""
        if n_bytes <= 0:
            return 0.0
        return float(n_bytes) / self.bcast_bytes_per_flash


# ---------------------------------------------------------------------------
# Closed-form throughputs (Appendix A.2 / A.3)
# ---------------------------------------------------------------------------

def conventional_throughput(hw: HardwareModel, N: int, B: int, G: int,
                            L: int) -> Tuple[float, float, float]:
    """Uniform length distribution 1..L (paper A.4). Returns
    (r_conv, r_gen, r_train) in tokens/flash. Eq. 10-15."""
    S = B * G
    K = S * (L + 1) / 2.0  # total tokens
    t_gen = 0.0
    for l in range(1, L + 1):
        h = S * (1.0 - (l - 1) / L) / N  # sequences still in progress / chip
        t_gen += hw.step_cost(h)
    t_train = K * hw.tau / N
    r_gen = K / max(t_gen, 1e-12)
    r_train = N / hw.tau
    return K / (t_gen + t_train), r_gen, r_train


def pipeline_throughput(hw: HardwareModel, N: int, B: int, I: int, H: int,
                        L: int) -> Tuple[float, float, float, int]:
    """Eq. 16-18. I generation chips at per-chip batch H; N-I training.
    Returns (r, r_gen, r_train, g_max)."""
    r_gen = float(hw.U(H)) * I
    r_train = (N - I) / hw.tau
    Lbar = (L + 1) / 2.0
    g_max = math.ceil(H * I * L / (Lbar * B))
    return min(r_gen, r_train), r_gen, r_train, g_max


def best_pipeline_config(hw: HardwareModel, N: int, B: int, L: int,
                         g_max_limit: float = float("inf")):
    """Exhaustive (I, H) search maximizing throughput subject to the max-lag
    constraint (Appendix A.3)."""
    best = None
    for I in range(1, N):
        for H in list(range(1, 64)) + list(range(64, 1025, 4)):
            r, r_gen, r_train, g = pipeline_throughput(hw, N, B, I, H, L)
            if g > g_max_limit:
                continue
            if best is None or r > best[0]:
                best = (r, I, H, g, r_gen, r_train)
    return best


def fig9_curves(hw: HardwareModel, N: int = 128, B: int = 128, L: int = 2048,
                g_grid: Iterable[int] = (2, 4, 8, 16, 32, 64, 96, 128, 133,
                                         160, 192, 256)):
    """Reproduces paper Fig. 9: throughput vs max lag for both systems."""
    rows = []
    for g in g_grid:
        r_conv, _, _ = conventional_throughput(hw, N, B, max(g, 1), L)
        bp = best_pipeline_config(hw, N, B, L, g_max_limit=g)
        r_pipe = bp[0] if bp else 0.0
        rows.append({
            "g_max": g, "r_conv": r_conv, "r_pipe": r_pipe,
            "speedup": r_pipe / max(r_conv, 1e-12),
            "I": bp[1] if bp else 0, "H": bp[2] if bp else 0,
        })
    return rows
