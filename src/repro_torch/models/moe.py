"""Mixture-of-Experts: a float32 router, top-k dispatch with a capacity per
expert, SwiGLU experts and optional shared experts.

The counterpart of the JAX package's `repro.models.moe` on one device.
Routing is copied decision for decision, since a token past its expert's
capacity is dropped and one changed choice changes the output: k
sequential top-1 passes over the float32 router probabilities (each pass
takes the first of tied maxima, as `jnp.argmax` does), a position-in-expert
cumsum whose counts carry from pass to pass, and an overflow row `E * C`
that swallows every dropped token. Each pass scatters its (T, d) rows into
an (E * C + 1, d) buffer, so no (T, E, C) dispatch tensor and no (T * k, d)
gather is made. The capacity is that of the whole call: every row of the
batch routes its tokens and takes capacity, so a row's output depends on
its neighbours (ROADMAP.md C.9).

The expert products are `torch.bmm`, as the JAX package computes them
outside any Pallas kernel. Its expert-parallel branch (`shard_map` over the
"model" mesh axis) waits for the port's distribution (ROADMAP.md A.7e).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def moe_shapes(cfg: ModelConfig, n_stack: int) -> Dict[str, Any]:
    """(shape, dtype, init scale) of the MoE leaves of `n_stack` stacked
    layers, as `repro.models.moe.moe_defs` defines them: the router in
    float32, the experts and the shared experts in the model dtype."""
    d, dt = cfg.d_model, cfg.dtype
    E, Fd = cfg.n_experts, cfg.moe_d_ff
    L = n_stack
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    shapes = {
        "router": ((L, d, E), torch.float32, 0.02),
        "gate": ((L, E, d, Fd), dt, 0.02),
        "up": ((L, E, d, Fd), dt, 0.02),
        "down": ((L, E, Fd, d), dt, out_scale),
    }
    if cfg.n_shared_experts:
        SF = cfg.moe_d_ff * cfg.n_shared_experts
        shapes.update({
            "shared_gate": ((L, d, SF), dt, 0.02),
            "shared_up": ((L, d, SF), dt, 0.02),
            "shared_down": ((L, SF, d), dt, out_scale),
        })
    return shapes


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of `n_tokens` tokens: k * T * factor / E,
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(cfg.experts_per_token * n_tokens * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def moe_local(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) tokens; p: one layer's router (d, E) and experts (E, ...).
    Returns (out (T, d), the load-balance aux loss, a float32 scalar)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(T, cfg)

    probs = torch.softmax(x.float() @ p["router"], dim=-1)       # (T,E)

    # load-balance auxiliary loss (Switch-style)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, E).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))

    # top-k routing as k sequential top-1 passes
    masked = probs
    rows = torch.arange(T, device=x.device)
    counts = torch.zeros(E, dtype=torch.long, device=x.device)
    dests, weights = [], []
    for _ in range(k):
        e = torch.argmax(masked, dim=-1)                         # (T,)
        w = masked.gather(1, e[:, None])[:, 0]                   # (T,)
        onehot = F.one_hot(e, E)                                 # (T,E)
        masked = masked * (1.0 - onehot.float())
        # the tokens before t routed to e[t] in this pass: the inclusive
        # cumsum over tokens, less t itself. Scanned along the last axis of
        # the (E,T) transpose: CUDA's scan over the first axis of (T,E)
        # took 1.4 ms per call at T 8192 on an H100 (PERF.md §6)
        before = torch.cumsum(onehot.T.contiguous(), dim=1)[e, rows] - 1
        pos = counts[e] + before
        counts = counts + onehot.sum(dim=0)
        dests.append(torch.where(pos < C, e * C + pos,
                                 torch.full_like(pos, E * C)))
        weights.append(w)

    # dispatch: scatter the (T,d) rows of every pass into (E*C [+ovf], d),
    # in place (an out-of-place add would copy the buffer once per pass)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    for dest in dests:
        buf.index_add_(0, dest, x)
    eb = buf[:E * C].reshape(E, C, d)

    # expert FFN (SwiGLU), batched over the experts
    g = torch.bmm(eb, p["gate"])
    u = torch.bmm(eb, p["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    eo = torch.bmm(h, p["down"])                                 # (E,C,d)

    # combine: gather back per pass, router-weighted, in x's dtype
    flat = torch.cat([eo.reshape(E * C, d),
                      torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for dest, w in zip(dests, weights):
        out = out + flat[dest] * w[:, None].to(x.dtype)
    return out, aux


def moe_apply(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), every token of the call routed together. Returns
    (out (B, S, d), aux_loss)."""
    B, S, d = x.shape
    routed = {k: p[k] for k in ("router", "gate", "up", "down")}
    out, aux = moe_local(routed, x.reshape(B * S, d), cfg)
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        g = x @ p["shared_gate"]
        u = x @ p["shared_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        out = out + h @ p["shared_down"]
    return out, aux
