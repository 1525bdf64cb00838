"""Ambient sharding context.

Model code annotates activations with *logical* axes via `constrain`;
outside a mesh context this is the identity, inside it redistributes a
DTensor to the placements the rules give (the analogue of
`with_sharding_constraint`). This keeps the model definitions
mesh-agnostic: one device on the CPU or the card, a fake 128-rank mesh in
the dry-run.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

from repro_torch.sharding import DEFAULT_RULES, logical_to_spec, placements_for

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx", default=None)


@contextlib.contextmanager
def sharding_context(mesh, rules=None):
    """Inside, `constrain` binds to `mesh` under DEFAULT_RULES updated by
    `rules`; plain tensors mixed with DTensors count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    tok = _CTX.set((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.reset(tok)


def current_mesh():
    ctx = _CTX.get()
    return ctx[0] if ctx else None


def current_rules():
    ctx = _CTX.get()
    return ctx[1] if ctx else None


def merged_rules():
    """DEFAULT_RULES updated by the current context's rules."""
    return dict(DEFAULT_RULES, **(current_rules() or {}))


def is_distributed(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, logical: Sequence[Optional[str]]):
    """x redistributed to the placements of its logical axes under the
    current rules; the identity outside a context or on a plain tensor."""
    ctx = _CTX.get()
    if ctx is None or not is_distributed(x):
        return x
    mesh, rules = ctx
    spec = logical_to_spec(logical, x.shape, mesh, rules)
    placements = placements_for(spec, mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def local_call(fn, tensors, dims, out_dims, **kwargs):
    """Call a kernel wrapper `fn(*tensors, **kwargs)` on local shards, the
    `shard_map` of one kernel call. A kernel is independent across its
    batch rows and its heads and nothing else, so each DTensor input is
    first redistributed to be split only there: its batch dim over the mesh
    axes that split the largest input's batch dim, and its head dim over the
    axes that split the head dim of every input that has one (the query
    heads follow the KV heads, so GQA's h // rep stays local). dims: per
    input (batch dim or None, head dim or None); out_dims: the same per
    output. A
    call with no DTensor input, or outside a context, is `fn` itself, so
    the wrappers only ever see plain tensors."""
    ctx = _CTX.get()
    if ctx is None or not any(is_distributed(t) for t in tensors):
        return fn(*tensors, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = ctx[0]

    def axes_on(t, dim):
        if dim is None or not is_distributed(t):
            return set()
        return {i for i, p in enumerate(t.placements)
                if isinstance(p, Shard) and p.dim == dim}

    # the batch split of the largest input is kept; the others follow it
    big = max((i for i, t in enumerate(tensors)
               if is_distributed(t) and dims[i][0] is not None),
              key=lambda i: tensors[i].numel(), default=0)
    batch_axes = axes_on(tensors[big], dims[big][0])
    head_sets = [axes_on(t, d[1]) for t, d in zip(tensors, dims)
                 if d[1] is not None]
    head_axes = set.intersection(*head_sets) if head_sets else set()
    head_axes -= batch_axes

    def target(bd, hd):
        out = [Replicate()] * mesh.ndim
        if bd is not None:
            for i in batch_axes:
                out[i] = Shard(bd)
        if hd is not None:
            for i in head_axes:
                out[i] = Shard(hd)
        return out

    local = []
    for t, (bd, hd) in zip(tensors, dims):
        if not is_distributed(t):
            if ((bd is not None and batch_axes)
                    or (hd is not None and head_axes)):
                raise ValueError("local_call: a plain tensor among "
                                 "distributed ones must be replicated")
            local.append(t)
            continue
        want = target(bd, hd)
        if tuple(t.placements) != tuple(want):
            t = t.redistribute(mesh, want)
        local.append(t.to_local())
    out = fn(*local, **kwargs)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(DTensor.from_local(o, mesh, target(bd, hd),
                                       run_check=False)
                    for o, (bd, hd) in zip(outs, out_dims))
    return wrapped[0] if single else wrapped


def split_dim(t, dim: int, *sizes):
    """A view of t's dim `dim` as `sizes` (their product). A DTensor whose
    dim is split over mesh axes that do not divide sizes[0] (25 heads on a
    model axis of 8) is first gathered on those axes; its other placements
    stay."""
    dim = dim % t.dim()
    if is_distributed(t):
        from torch.distributed.tensor import Replicate, Shard

        split = [i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim % t.dim() == dim]
        n = 1
        for i in split:
            n *= t.device_mesh.size(i)
        if split and sizes[0] % n:
            place = list(t.placements)
            for i in split:
                place[i] = Replicate()
            t = t.redistribute(t.device_mesh, place)
    return t.view(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def split_last(t, *sizes):
    """`split_dim` of the last dim."""
    return split_dim(t, -1, *sizes)


class _Merge(torch.autograd.Function):
    """Dims `dim` and `dim + 1` of t flattened; the backward splits the
    gradient back through `split_dim`, so an unevenly split gradient is
    gathered first rather than refused."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.sizes = dim, tuple(t.shape[dim:dim + 2])
        return t.reshape(*t.shape[:dim], -1, *t.shape[dim + 2:])

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, *ctx.sizes), None


def merge_dims(t, dim: int):
    """t with dims `dim` and `dim + 1` flattened into one: a reshape, whose
    gradient a DTensor unflattens safely (`split_dim`)."""
    dim = dim % t.dim()
    if not is_distributed(t):
        return t.reshape(*t.shape[:dim], -1, *t.shape[dim + 2:])
    return _Merge.apply(t, dim)


def merge_last(t):
    """`merge_dims` of the last two dims."""
    return merge_dims(t, t.dim() - 2)


def gather_last(t, idx):
    """`t.gather(-1, idx)`. Under a mesh with t's last dim split (logits
    split over the vocab), each rank reads the ids in its slice and the
    result is a partial sum over those axes (one owner per id), so no
    rank gathers the whole last dim."""
    if not is_distributed(t):
        return t.gather(-1, idx)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    last = t.dim() - 1
    mesh = t.device_mesh
    split = [i for i, p in enumerate(t.placements)
             if isinstance(p, Shard) and p.dim % t.dim() == last]
    if not split:
        return t.gather(-1, idx)
    i_place = [Replicate() if i in split else p
               for i, p in enumerate(t.placements)]
    if not is_distributed(idx):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if tuple(idx.placements) != tuple(i_place):
        idx = idx.redistribute(mesh, i_place)
    local_shape, off = compute_local_shape_and_global_offset(
        t.shape, mesh, t.placements)
    tl, il = t.to_local(), idx.to_local() - off[last]
    owned = (il >= 0) & (il < local_shape[last])
    g = tl.gather(-1, il.clamp(0, local_shape[last] - 1))
    g = torch.where(owned, g, torch.zeros_like(g))
    out = [Partial() if i in split else p for i, p in enumerate(i_place)]
    return DTensor.from_local(g, mesh, out, run_check=False)
