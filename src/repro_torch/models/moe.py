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
outside any Pallas kernel. Under a mesh the experts run expert-parallel
over the "model" axis (`_moe_expert_parallel`), every capacity decision
that of the unsharded path on the same tokens.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.shardctx import (current_mesh, current_rules, full,
                                  is_distributed, redistribute)


def moe_shapes(cfg: ModelConfig, n_stack: int) -> Dict[str, Any]:
    """(shape, dtype, init scale, logical axes) of the MoE leaves of `n_stack` stacked
    layers, as `repro.models.moe.moe_defs` defines them: the router in
    float32, the experts and the shared experts in the model dtype."""
    d, dt = cfg.d_model, cfg.dtype
    E, Fd = cfg.n_experts, cfg.moe_d_ff
    L = n_stack
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    shapes = {
        "router": ((L, d, E), torch.float32, 0.02,
                   ("layers", "p_embed", "p_experts")),
        "gate": ((L, E, d, Fd), dt, 0.02,
                 ("layers", "p_experts", "p_embed", "p_mlp")),
        "up": ((L, E, d, Fd), dt, 0.02,
               ("layers", "p_experts", "p_embed", "p_mlp")),
        "down": ((L, E, Fd, d), dt, out_scale,
                 ("layers", "p_experts", "p_mlp", "p_embed")),
    }
    if cfg.n_shared_experts:
        SF = cfg.moe_d_ff * cfg.n_shared_experts
        shapes.update({
            "shared_gate": ((L, d, SF), dt, 0.02,
                            ("layers", "p_embed", "p_mlp")),
            "shared_up": ((L, d, SF), dt, 0.02,
                          ("layers", "p_embed", "p_mlp")),
            "shared_down": ((L, SF, d), dt, out_scale,
                            ("layers", "p_mlp", "p_embed")),
        })
    return shapes


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of `n_tokens` tokens: k * T * factor / E,
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(cfg.experts_per_token * n_tokens * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def route(probs, cfg: ModelConfig, C: int, n_local: int, offset: int):
    """Top-k routing as k sequential top-1 passes over probs (T, E).
    Returns, per pass, each token's destination row in the local
    (n_local * C + 1, d) buffer (the overflow row n_local * C for a choice
    past its expert's capacity or outside [offset, offset + n_local)) and
    its router weight. Every rank routes over all E experts, so the
    capacity decisions do not depend on the experts a rank holds."""
    T, E = probs.shape
    masked = probs
    rows = torch.arange(T, device=probs.device)
    counts = torch.zeros(E, dtype=torch.long, device=probs.device)
    dests, weights = [], []
    for _ in range(cfg.experts_per_token):
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
        local = (e >= offset) & (e < offset + n_local) & (pos < C)
        dests.append(torch.where(local, (e - offset) * C + pos,
                                 torch.full_like(pos, n_local * C)))
        weights.append(w)
    return dests, weights


def moe_local(p, x, cfg: ModelConfig, n_local: Optional[int] = None,
              offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) tokens; p: one layer's router (d, E) and its experts
    [offset, offset + n_local) (n_local, ...), all E by default. Every
    token routes over all E experts with the capacity of T tokens; only
    the local experts' contributions are computed (the others' tokens land
    in the overflow row). Returns (out (T, d), the load-balance aux loss, a
    float32 scalar)."""
    T, d = x.shape
    E = cfg.n_experts
    n_local = E if n_local is None else int(n_local)
    C = _capacity(T, cfg)

    probs = torch.softmax(x.float() @ p["router"], dim=-1)       # (T,E)

    # load-balance auxiliary loss (Switch-style)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, E).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))

    dests, weights = route(probs, cfg, C, n_local, offset)

    # dispatch: scatter the (T,d) rows of every pass into
    # (n_local*C [+ovf], d), in place (an out-of-place add would copy the
    # buffer once per pass)
    buf = torch.zeros((n_local * C + 1, d), dtype=x.dtype, device=x.device)
    for dest in dests:
        buf.index_add_(0, dest, x)
    eb = buf[:n_local * C].reshape(n_local, C, d)

    # expert FFN (SwiGLU), batched over the local experts
    g = torch.bmm(eb, p["gate"])
    u = torch.bmm(eb, p["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    eo = torch.bmm(h, p["down"])                           # (n_local,C,d)

    # combine: gather back per pass, router-weighted, in x's dtype
    flat = torch.cat([eo.reshape(n_local * C, d),
                      torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for dest, w in zip(dests, weights):
        out = out + flat[dest] * w[:, None].to(x.dtype)
    return out, aux


def _moe_expert_parallel(p, xf, cfg: ModelConfig, mesh):
    """The expert-parallel branch, the JAX package's `shard_map` of
    `_moe_local` (`models/moe.py:128-158`), on explicit local tensors:
    tokens split over ("pod", "data") as the batch rule gives and
    replicated along "model", experts split over "model". Each model rank
    routes its tokens over all E experts with the capacity of its tokens,
    computes its E/ep experts' contributions, and the outputs are summed
    over "model"; the aux loss is averaged over "pod"/"data".

    Gradients follow the shard_map's: a replicated input's local gradient
    is a partial sum (over "model" for the tokens; over every axis for the
    router and over the token axes for the experts). Every model rank
    computes the same aux loss, so each carries 1/ep of it into the sum
    over "model", which leaves the value exact (ep is a power of two on
    the production mesh) and counts its gradient once."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.kernels.sharded import _SumShards
    from repro_torch.sharding import logical_to_spec, placements_for

    names = list(mesh.mesh_dim_names)
    m_ax = names.index("model")
    ep = mesh.size(m_ax)
    n_local = cfg.n_experts // ep
    x_place = placements_for(
        logical_to_spec(("batch", "embed"), xf.shape, mesh, current_rules()),
        mesh)
    tok_axes = [i for i, pl in enumerate(x_place) if isinstance(pl, Shard)]

    def grad_of(place, partial_axes):
        out = list(place)
        for i in partial_axes:
            out[i] = Partial()
        return out

    rep = [Replicate()] * mesh.ndim
    e_place = list(rep)
    e_place[m_ax] = Shard(0)
    every = range(mesh.ndim)

    def local(t, place, grad):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return redistribute(t, mesh, place).to_local(grad_placements=grad)

    xl = local(xf, x_place, grad_of(x_place, [m_ax]))
    pl = {"router": local(p["router"], rep, grad_of(rep, every))}
    for k in ("gate", "up", "down"):
        pl[k] = local(p[k], e_place, grad_of(e_place, tok_axes))
    out, aux = moe_local(pl, xl, cfg, n_local=n_local,
                         offset=mesh.get_local_rank("model") * n_local)
    out = _SumShards.apply(out, mesh.get_group("model"))
    aux = _SumShards.apply(aux / ep, mesh.get_group("model"))
    for i in tok_axes:
        aux = _SumShards.apply(aux, mesh.get_group(names[i])) / mesh.size(i)
    return (DTensor.from_local(out, mesh, x_place, run_check=False),
            DTensor.from_local(aux, mesh, rep, run_check=False))


def _moe_replicated(p, xf, cfg: ModelConfig, mesh):
    """Under a mesh without expert parallelism: every rank routes all the
    call's tokens over all experts (the unsharded decisions)."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * mesh.ndim
    out, aux = moe_local({k: full(v) for k, v in p.items()}, full(xf), cfg)
    return (DTensor.from_local(out, mesh, rep, run_check=False),
            DTensor.from_local(aux, mesh, rep, run_check=False))


def moe_apply(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), every token of the call routed together. Returns
    (out (B, S, d), aux_loss). Under a mesh with a "model" axis that
    divides E the experts run expert-parallel (`_moe_expert_parallel`)."""
    B, S, d = x.shape
    routed = {k: p[k] for k in ("router", "gate", "up", "down")}
    xf = x.reshape(B * S, d)
    mesh = current_mesh()
    if mesh is None or not is_distributed(x):
        out, aux = moe_local(routed, xf, cfg)
    elif ("model" in mesh.mesh_dim_names and cfg.n_experts
          % mesh.size(mesh.mesh_dim_names.index("model")) == 0):
        out, aux = _moe_expert_parallel(routed, xf, cfg, mesh)
    else:
        out, aux = _moe_replicated(routed, xf, cfg, mesh)
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        g = x @ p["shared_gate"]
        u = x @ p["shared_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        out = out + h @ p["shared_down"]
    return out, aux
