"""Ambient sharding context.

Model code annotates activations with *logical* axes via `constrain`;
outside a mesh context this is the identity, inside it redistributes a
DTensor to the placements the rules give (the analogue of
`with_sharding_constraint`). This keeps the model definitions
mesh-agnostic: one device on the CPU or the card, a fake 128-rank mesh in
the dry-run.

On a gloo process group every gather (a mesh dim going from Shard to
Replicate) runs through the process group's own all-gather
(`redistribute`): DTensor's functional all-gather of CUDA tensors on gloo
crashes in torch 2.11 (a segfault on the card), where the c10d
`all_gather_into_tensor`, which stages the bytes through host memory,
works, as do gloo's all-reduce, reduce-scatter and broadcast, which
DTensor keeps. Other backends (NCCL, the dry-run's fake group) take
DTensor's own collectives.
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


def current():
    """The current (mesh, rules), or None, for `resume`."""
    return _CTX.get()


@contextlib.contextmanager
def resume(ctx):
    """Re-enter a context taken by `current()`: the autograd engine runs a
    CUDA backward on its own thread, where an activation checkpoint's
    recompute would otherwise see no context."""
    if ctx is None:
        yield
        return
    with sharding_context(*ctx):
        yield


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


# gathers this process made through the process group's all-gather:
# {"gathers": calls, "bytes": gathered bytes}; the mesh runtime reports it
STAGED = {"gathers": 0, "bytes": 0}


def staged(mesh) -> bool:
    """True when `mesh`'s groups run on gloo, whose gathers `redistribute`
    takes through the process group's all-gather."""
    import torch.distributed as dist
    try:
        return dist.get_backend(mesh.get_group(0)) == "gloo"
    except (RuntimeError, ValueError, AttributeError):
        return False


def _gather_local(t, i: int, dst):
    """The local tensor of DTensor `t` once mesh dim `i` (a Shard) is
    replicated (`dst` is t's placements with that change): the blocks of
    the dim's group, each padded to the largest along the split tensor
    dim, gathered by one c10d all-gather and cut back to their sizes (a
    Shard splits as `torch.chunk` does, so the ranks know every size)."""
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = t.device_mesh
    d = t.placements[i].dim % t.dim()
    n = mesh.size(i)
    shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, dst)
    sizes = [c.numel() for c in torch.arange(shape[d]).chunk(n)]
    sizes += [0] * (n - len(sizes))
    local = t.to_local()
    m = max(sizes)
    if local.shape[d] < m:
        pad = list(local.shape)
        pad[d] = m - local.shape[d]
        local = torch.cat([local, local.new_zeros(pad)], d)
    local = local.contiguous()
    as_bool = local.dtype == torch.bool
    if as_bool:
        local = local.to(torch.uint8)
    out = local.new_empty((n * local.shape[0],) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=mesh.get_group(i))
    out = out.view((n,) + tuple(local.shape))
    STAGED["gathers"] += 1
    STAGED["bytes"] += out.numel() * out.element_size()
    res = torch.cat([out[c].narrow(d, 0, sizes[c]) for c in range(n)], d)
    return res.bool() if as_bool else res


class _StagedGather(torch.autograd.Function):
    """Mesh dim `i` of DTensor t from Shard to Replicate through the
    process group's all-gather. Backward: the gradient back to t's
    placements (each rank's block cut out, or a partial sum
    reduce-scattered; no gather)."""

    @staticmethod
    def forward(ctx, t, i):
        from torch.distributed.tensor import DTensor, Replicate

        ctx.src = tuple(t.placements)
        dst = list(t.placements)
        dst[i] = Replicate()
        out = _gather_local(t, i, dst)
        return DTensor.from_local(out, t.device_mesh, dst, run_check=False,
                                  shape=t.shape, stride=t.stride())

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, g.device_mesh, ctx.src), None


def redistribute(t, mesh, placements):
    """`t.redistribute(mesh, placements)`; on a gloo mesh each Shard that
    moves is first gathered by `_StagedGather` (innermost mesh dim first,
    as DTensor nests the shards of one tensor dim), and the rest (local
    slicing, partial sums reduced) is DTensor's. A rank outside the mesh
    holds nothing and moves nothing."""
    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    if mesh.get_coordinate() is None or not staged(mesh):
        return t.redistribute(mesh, placements)
    for i in reversed(range(mesh.ndim)):
        p = t.placements[i]
        if p.is_shard() and p != placements[i]:
            t = _StagedGather.apply(t, i)
    return t if tuple(t.placements) == placements \
        else t.redistribute(mesh, placements)


def full(x):
    """The whole of `x` as a plain tensor on every rank of its mesh (a
    plain tensor as it is); outside the mesh, its empty local tensor."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return redistribute(x, mesh, [Replicate()] * mesh.ndim).to_local()


class _Constrain(torch.autograd.Function):
    """A sharding constraint on a value and on its gradient, as
    `with_sharding_constraint` transposes: the gradient is brought to the
    same placements (a partial sum reduced) before it returns to the
    input's layout, so no partial gradient reaches the products behind
    it (DTensor would gather their weights to take one)."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.place, ctx.src = mesh, placements, tuple(x.placements)
        return redistribute(x, mesh, placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        g = redistribute(g, ctx.mesh, ctx.place)
        src = [Replicate() if p.is_partial() else p for p in ctx.src]
        return redistribute(g, ctx.mesh, src), None, None


def constrain(x, logical: Sequence[Optional[str]]):
    """x redistributed to the placements of its logical axes under the
    current rules, its gradient constrained alike (`_Constrain`); the
    identity outside a context or on a plain tensor."""
    ctx = _CTX.get()
    if ctx is None or not is_distributed(x):
        return x
    mesh, rules = ctx
    spec = logical_to_spec(logical, x.shape, mesh, rules)
    placements = tuple(placements_for(spec, mesh))
    if tuple(x.placements) == placements:
        return x
    return _Constrain.apply(x, mesh, placements)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a kernel's
    backward may hand back a permuted gradient, and DTensor's views of the
    shard it becomes need the layout a forward would have had."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


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
        local.append(_ContiguousGrad.apply(
            redistribute(t, mesh, want).to_local()))
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
            t = redistribute(t, t.device_mesh, place)
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
    idx = redistribute(idx, mesh, i_place)
    local_shape, off = compute_local_shape_and_global_offset(
        t.shape, mesh, t.placements)
    tl, il = t.to_local(), idx.to_local() - off[last]
    owned = (il >= 0) & (il < local_shape[last])
    g = tl.gather(-1, il.clamp(0, local_shape[last] - 1))
    g = torch.where(owned, g, torch.zeros_like(g))
    out = [Partial() if i in split else p for i, p in enumerate(i_place)]
    return DTensor.from_local(g, mesh, out, run_check=False)
