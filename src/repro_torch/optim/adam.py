"""Adam (Kingma, 2014) with float32 moments over a bf16/f32 param tree.

Functional, as the JAX package's `optim/adam.py`: `adam_update` returns new
parameter and moment tensors and never writes into the ones it is given,
because a generation engine may be decoding with the current parameters
while the trainer steps (an in-place update would change the behavior
weights under a running engine and break its version stamps).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.weights import tree_flatten, tree_unflatten
from repro_torch.shardctx import is_distributed

# elements per slice when a large leaf is updated slice by slice along its
# first axis: bounds the float32 temporaries of one leaf's update
_SLICE = 1 << 24


class AdamState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-6  # paper: Adam, lr 1e-6
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0


def adam_init(params) -> AdamState:
    leaves, treedef = tree_flatten(params)

    def zeros():
        return tree_unflatten(treedef, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves])

    return AdamState(step=torch.zeros((), dtype=torch.int32,
                                      device=leaves[0].device),
                     m=zeros(), v=zeros())


def global_norm(tree) -> torch.Tensor:
    leaves = tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def _slices(t: torch.Tensor):
    """Index ranges along the first axis that cut `t` into pieces of at most
    about `_SLICE` elements (the whole tensor when it is small)."""
    if t.dim() == 0 or t.numel() <= _SLICE:
        return [slice(None)]
    rows = max(1, _SLICE // max(t.numel() // t.shape[0], 1))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def adam_update(params, grads, state: AdamState, cfg: AdamConfig, lr=None,
                *, gnorm: Optional[torch.Tensor] = None,
                bad: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, grad_norm). `lr` (a 0-d tensor from
    a schedule) overrides cfg.lr when given; `gnorm` is the gradients'
    global norm when the caller has it already.

    bad: optional 0-d bool tensor, the non-finite guard's verdict. Where it
    is True every output keeps its old value (`torch.where(bad, old, new)`,
    which returns `new` bitwise when False), leaf by leaf, so a guarded
    update holds one leaf's old and new values together, not two trees."""
    lr = cfg.lr if lr is None else lr
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else None)
    step = state.step + 1
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        g = g.float()
        if scale is not None:
            g = g * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    def guarded(p, g, m, v):
        new = upd(p, g, m, v)
        if bad is None:
            return new
        return tuple(torch.where(bad, o, n) for o, n in zip((p, m, v), new))

    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state.m)[0]
    flat_v = tree_flatten(state.v)[0]
    out_p, out_m, out_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        # a distributed leaf is updated whole: each rank holds its shard
        parts = [slice(None)] if is_distributed(p) else _slices(p)
        if len(parts) == 1:
            np_, nm, nv = guarded(p, g, m, v)
        else:
            np_, nm, nv = (torch.empty_like(x) for x in (p, m, v))
            for sl in parts:
                for dst, src in zip((np_, nm, nv),
                                    guarded(p[sl], g[sl], m[sl], v[sl])):
                    dst[sl] = src
        out_p.append(np_)
        out_m.append(nm)
        out_v.append(nv)
    if bad is not None:
        step = torch.where(bad, state.step, step)
    return (tree_unflatten(treedef, out_p),
            AdamState(step, tree_unflatten(treedef, out_m),
                      tree_unflatten(treedef, out_v)),
            gnorm)
