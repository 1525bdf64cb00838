"""The vocab-parallel fused lm-head loss: `fused_logprob` sharded over the
vocab axis of a mesh, the JAX package's `fused_logprob_sharded`
(`kernels/fused_logprob.py:550-636`).

Each shard holds V/n head columns and runs the ordinary fused path
(`kernels.ops.fused_logprob`: on the card the hand-written forward and
backward kernels) on its slice, with the targets clipped into it. Three
(N,) sums and one (N,) max over the vocab axis combine the shards:

    lse     = m + log sum_i exp(lse_i - m)           (m = max_i lse_i)
    entropy = lse - sum_i exp(lse_i - lse) * (lse_i - ent_i)
    logprob = sum_i owned_i * (lp_i + lse_i) - lse   (one owner per row)

so no (N, V) tensor crosses the mesh, and the kernels see only local,
plain tensors. The JAX package takes the max from an all-gather, as
`pmax` has no autodiff rule there; here the max carries no gradient and
is one all-reduce. The sums are differentiable: a sum's backward hands
every shard the gradient of the replicated result, and a replicated value
that enters the per-shard terms sums its gradient over the shards.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(x, "sum", group)
    return out.wait() if hasattr(out, "wait") else out


class _SumShards(torch.autograd.Function):
    """Forward: the sum over the shards. Backward: each shard's term gets
    the (replicated) gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterShards(torch.autograd.Function):
    """Forward: identity on a replicated value. Backward: its gradient is
    the sum of every shard's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group), None


def _max_shards(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the shards (an all-reduce; no gradient)."""
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(x.contiguous(), "max", group)
    return out.wait() if hasattr(out, "wait") else out


def vocab_shard_count(mesh, axis_name, vocab: int) -> int:
    """Usable vocab shards: the size of `axis_name` on `mesh` when it
    exists and divides `vocab`, else 1 (the caller takes the replicated
    path: the divisibility drop of `sharding.logical_to_spec`)."""
    if mesh is None or not isinstance(axis_name, str) \
            or axis_name not in (mesh.mesh_dim_names or ()):
        return 1
    n = int(mesh.size(mesh.mesh_dim_names.index(axis_name)))
    return n if n > 1 and vocab % n == 0 else 1


def fused_logprob_sharded(hidden, head, targets, *, mesh=None,
                          axis_name="model", transpose_head: bool = False,
                          dw_chunks: int = 1):
    """`fused_logprob` sharded over the vocab axis of `mesh`.

    hidden (N, D) and targets (N,) enter replicated; the head enters split
    along its vocab dim over `axis_name` (rows when transpose_head, columns
    otherwise), as `sharding.DEFAULT_RULES` places `p_vocab` /
    `p_embed_vocab`; every input is redistributed so. Returns (logprob,
    lse, entropy), each (N,) float32, replicated DTensors. The unsharded
    call takes over when `mesh` is None, the axis is missing or of size 1,
    or V does not divide, as in the JAX package."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.shardctx import redistribute

    V = head.shape[0] if transpose_head else head.shape[1]
    n = vocab_shard_count(mesh, axis_name, V)
    kw = dict(transpose_head=bool(transpose_head), dw_chunks=int(dw_chunks))
    if mesh is None:
        return kops.fused_logprob(hidden, head, targets, **kw)
    rep = [Replicate()] * mesh.ndim

    def placed(x, placements):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, rep, run_check=False)
        return redistribute(x, mesh, placements)

    if n <= 1:
        outs = kops.fused_logprob(placed(hidden, rep).to_local(),
                                  placed(head, rep).to_local(),
                                  placed(targets, rep).to_local(), **kw)
        return tuple(DTensor.from_local(o, mesh, rep, run_check=False)
                     for o in outs)

    ax = list(mesh.mesh_dim_names).index(axis_name)
    w_place = list(rep)
    w_place[ax] = Shard(0 if transpose_head else 1)
    h_grad = list(rep)
    h_grad[ax] = Partial()
    group = mesh.get_group(axis_name)
    v_local = V // n
    # the shard's hidden gradient is its vocab slice's share of the sum
    h = placed(hidden, rep).to_local(grad_placements=h_grad)
    w = placed(head, w_place).to_local()
    t = placed(targets, rep).to_local().long()
    off = mesh.get_local_rank(axis_name) * v_local
    lp_i, lse_i, ent_i = kops.fused_logprob(
        h, w, (t - off).clamp(0, v_local - 1), **kw)
    owned = (t >= off) & (t < off + v_local)
    # a stable offset: any shared m gives the same lse, so m carries no
    # gradient
    m = _max_shards(lse_i.detach(), group)
    lse = m + torch.log(_SumShards.apply(torch.exp(lse_i - m), group))
    lse_in = _EnterShards.apply(lse, group)
    ent = lse - _SumShards.apply(
        torch.exp(lse_i - lse_in) * (lse_i - ent_i), group)
    # non-owner rows read a clipped (wrong) id: where() drops their term
    # and zeroes its gradient
    tgt = _SumShards.apply(torch.where(owned, lp_i + lse_i,
                                       torch.zeros_like(lp_i)), group)
    return tuple(DTensor.from_local(o, mesh, rep, run_check=False)
                 for o in (tgt - lse, lse, ent))
