"""Production mesh builders, mapped to the card.

The paper ran on 128 H100s: 16 nodes of 8 NVLink-connected GPUs. The
production mesh is `(16, 8)` over `("data", "model")`, the model axis being
the eight GPUs of one node; `multi_pod=True` gives `(2, 16, 8)` over
`("pod", "data", "model")`. Functions, not module-level constants, so
importing this module touches no process group.

The dry-run builds these meshes on a fake process group (`fake_world`):
one process stands for every rank, and collectives move no data.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def fake_world(world_size: int, rank: int = 0) -> None:
    """(Re)initialize this process's default process group as a fake one
    of `world_size` ranks, this process standing for `rank`: the dry-run's
    stand-in for a cluster. Any existing default group is destroyed."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() == world_size
                and dist.get_rank() == rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _mesh(ranks: torch.Tensor, names: Tuple[str, ...],
          device_type: str = "cuda"):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0):
    """The paper's 128 H100s as a (16, 8) ("data", "model") mesh on a fake
    process group (2 x 128 with `multi_pod`); this process stands for
    `rank`."""
    shape = (2, 16, 8) if multi_pod else (16, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    fake_world(n, rank)
    return _mesh(torch.arange(n).reshape(shape), axes)


def make_host_mesh():
    """The process group that exists, as a 1-D data mesh (one rank on a
    single card or the CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(dev, torch.arange(dist.get_world_size()),
                      mesh_dim_names=("data",))


def mesh_ranks(mesh) -> torch.Tensor:
    """The global ranks of a DeviceMesh, in its shape."""
    return mesh.mesh.clone()


def engine_submeshes(mesh, n_engines: int, axis_name: str = "model") -> List:
    """Split a mesh's ranks into `n_engines` disjoint 1D submeshes: the
    per-engine device sets of a real-mesh actor pool, on the mesh's device
    type. Ranks must split evenly. Every rank of the group makes every
    submesh (each is a process group), in the same order."""
    ranks = mesh_ranks(mesh).reshape(-1)
    n = int(n_engines)
    if n <= 0 or len(ranks) % n:
        raise ValueError(
            f"cannot split {len(ranks)} devices into {n} engine meshes")
    per = len(ranks) // n
    return [_mesh(ranks[i * per:(i + 1) * per], (axis_name,),
                  mesh.device_type) for i in range(n)]


def disaggregated_ranks(mesh, n_train_model: int = 4):
    """(trainer ranks, generator ranks), each shaped like the mesh with the
    "model" axis cut at `n_train_model`: the paper's T-vs-(N-T) split."""
    names = list(mesh.mesh_dim_names)
    ranks = mesh_ranks(mesh)
    ax = names.index("model")
    n_model = ranks.shape[ax]
    if not (0 < n_train_model < n_model):
        raise ValueError(f"n_train_model must be in (0, {n_model})")
    return (ranks.narrow(ax, 0, n_train_model),
            ranks.narrow(ax, n_train_model, n_model - n_train_model))


def make_disaggregated_meshes(mesh, n_train_model: int = 4):
    """PipelineRL resource split: trainer GPUs vs generator GPUs.

    Splits the trailing "model" axis of the production mesh into a trainer
    submesh and a generator submesh (the paper's T-vs-(N-T) knob mapped to
    a mesh partition; the default 4 is half the node, as the JAX package's
    8 is half of its 16). The in-flight weight update is the reshard
    between the two."""
    names = tuple(mesh.mesh_dim_names)
    train, gen = disaggregated_ranks(mesh, n_train_model)
    return _mesh(train, names), _mesh(gen, names)
