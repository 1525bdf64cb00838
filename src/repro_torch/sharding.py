"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

Every parameter and activation is annotated with *logical* axis names. A
rules table maps logical axes to mesh axes; `logical_to_spec` drops a mesh
axis whenever the dimension is not divisible by the mesh axis size (GQA
kv_heads=8 on a model axis of 16, batch=1 on data=16, ...), so one rule set
covers every architecture and input shape.

A spec is a tuple with one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of names (the dim sharded over several axes, major
to minor), the entries of the JAX package's `PartitionSpec`.
`placements_for` turns a spec into DTensor placements on a
`torch.distributed.device_mesh.DeviceMesh`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]

# Default rule set: FSDP over "data" (+"pod"), tensor parallel over "model".
# Tuple values mean the dimension is sharded over multiple mesh axes.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    # KV-cache length: flash-decode style sequence parallelism. Falls back
    # onto whichever axis the batch didn't consume
    "cache_seq": ("data", "model"),
    "embed": None,             # activation d_model stays replicated across TP
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",        # expert parallelism
    "expert_capacity": None,
    "prefix": None,
    # parameters: FSDP shards the non-TP dim over data, TP over model
    "p_embed": "data",
    "p_vocab": "model",
    "p_embed_vocab": "model",  # embedding table's vocab dim (gather operand)
    "p_heads": "model",
    "p_kv_heads": "model",
    "p_head_dim": None,
    "p_mlp": "model",
    "p_experts": "model",
    "p_lora": None,
    "p_inner": "model",        # SSM d_inner
    "p_conv": None,
    "p_state": None,
    "p_none": None,
}


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of any object with
    `axis_names` and `devices.shape` (a JAX mesh, or a stand-in)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def logical_to_spec(logical: Sequence[Optional[str]], dims: Sequence[int],
                    mesh, rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    """Map logical axis names (+ concrete dims) to a spec.

    A mesh axis is used only if (a) it exists in the mesh, (b) the dim is
    divisible by its size (after stacking with earlier axes of the same
    dim), and (c) it has not been consumed by an earlier dimension.
    """
    rules = dict(DEFAULT_RULES, **(rules or {}))
    sizes = axis_sizes(mesh)
    used: set = set()
    out: List[MeshAxes] = []
    for name, dim in zip(logical, dims):
        entry: MeshAxes = rules.get(name) if name else None
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        picked = []
        shard = 1
        for ax in axes:
            if ax not in sizes or ax in used:
                continue
            if dim % (shard * sizes[ax]) != 0:
                continue
            picked.append(ax)
            shard *= sizes[ax]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return tuple(out)


def placements_for(spec: Spec, mesh) -> List[Any]:
    """DTensor placements (one per mesh dim) for `spec` on a DeviceMesh: a
    mesh axis named in the spec shards that tensor dim, an unused axis is
    Replicate(). A dim sharded over several axes must name them in the
    mesh's order (major to minor), as the rules do."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not "
                             f"in the mesh order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


class Annotated:
    """A tensor (a meta stand-in or real) tagged with logical axis names."""

    __slots__ = ("value", "logical")

    def __init__(self, value, logical: Sequence[Optional[str]]):
        if len(logical) != len(value.shape):
            raise ValueError(
                f"logical axes {logical} do not match shape {value.shape}")
        self.value = value
        self.logical = tuple(logical)


def spec_for(ann: Annotated, mesh, rules=None) -> Spec:
    return logical_to_spec(ann.logical, ann.value.shape, mesh, rules)


def tree_map(fn, tree, is_leaf=lambda x: isinstance(x, Annotated)):
    """Map fn over the leaves of a nested dict / list / tuple tree."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_specs(tree, mesh, rules=None):
    """Tree of Annotated -> tree of specs (same structure)."""
    return tree_map(lambda a: spec_for(a, mesh, rules), tree)


def tree_values(tree):
    return tree_map(lambda a: a.value, tree)


def tree_shardings(tree, mesh, rules=None):
    """Tree of Annotated -> tree of DTensor placements on `mesh`."""
    return tree_map(
        lambda a: placements_for(spec_for(a, mesh, rules), mesh), tree)


def distribute(value, mesh, placements, src_data_rank=0):
    """A DTensor on `mesh` with `placements` whose global tensor is `value`.
    A meta value becomes a meta DTensor without any data movement (the
    dry-run). A real value is the mesh's first rank's copy, scattered (or
    broadcast) from it, so the global tensor is one rank's whatever the
    others were handed; `src_data_rank=None` instead leaves each rank its
    block of its own copy with no traffic, for a copy that is the same on
    every rank by construction (one just gathered whole)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if value.device.type != "meta":
        return distribute_tensor(value, mesh, placements,
                                 src_data_rank=src_data_rank)
    sizes = list(value.shape)
    for mdim, p in enumerate(placements):
        if p.is_shard():
            sizes[p.dim] //= mesh.mesh.shape[mdim]
    local = value.new_empty(sizes)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=value.shape, stride=value.stride())
