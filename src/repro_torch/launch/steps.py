"""Step programs for the launcher and the dry-run.

For every (architecture x input shape x mesh) this module builds the step
and traces it on meta DTensors (`lower_program`):

  train   -> RL train_step (forward + IS-REINFORCE + Adam)
  prefill -> prompt forward building the KV cache
  decode  -> serve_step: ONE new token against a seq_len cache
  (plus)  -> weight_update: the in-flight weight transfer, a redistribute
             from the trainer layout (FSDP+TP) to the generation layout
             (TP only, FSDP gathered): its collectives are the paper's
             in-flight update cost.

A trace runs the port's own step functions eagerly, once, on meta DTensors
over a fake process group: nothing is computed and no memory is taken.
`roofline.analysis.TraceCounter` counts the shard-local work DTensor
dispatches, per device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, ShapeSpec, for_shape,
                                      input_logical, input_specs)
from repro_torch.core.algo import RLConfig
from repro_torch.core.trainer import TrainState, train_step
from repro_torch.core.weights import chunk_spans, span_bytes, tree_flatten
from repro_torch.device import synchronize
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig, AdamState
from repro_torch.sharding import (Annotated, distribute, logical_to_spec,
                                  placements_for, tree_map, tree_shardings,
                                  tree_values)

# generation engines keep tensor parallelism but gather the FSDP dim: the
# trainer->generator weight transfer is exactly this redistribute. The
# embedding table's vocab dim is replicated too
GEN_RULES = {"p_embed": None, "p_embed_vocab": None}


def abstract_params(cfg: ModelConfig):
    """Tree of Annotated meta tensors: every parameter leaf with its
    logical axes, no storage."""
    return M.map_entries(
        lambda e: Annotated(torch.empty(e[0], dtype=e[1], device="meta"),
                            e[3]), M.param_entries(cfg))


def abstract_train_state(cfg: ModelConfig) -> Tuple[Any, TrainState]:
    """(Annotated params, TrainState of meta tensors): float32 Adam
    moments, the tree of `init_train_state`."""
    ann = abstract_params(cfg)
    params = tree_values(ann)
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta")
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    opt = AdamState(step=scalar, m=tree_map(f32, params, _is_tensor),
                    v=tree_map(f32, params, _is_tensor))
    return ann, TrainState(params=params, opt=opt, version=scalar)


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def state_shardings(ann, mesh, rules=None) -> TrainState:
    """Placements of the train state: parameters and both moments by their
    logical axes, the counters replicated."""
    from torch.distributed.tensor import Replicate

    ps = tree_shardings(ann, mesh, rules)
    rep = [Replicate()] * mesh.ndim
    return TrainState(params=ps, opt=AdamState(step=rep, m=ps, v=ps),
                      version=rep)


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, rules=None):
    """(meta input specs, their placements) for a step's batch."""
    specs = input_specs(cfg, shape)
    logical = input_logical(cfg, shape)

    def place(v, log):
        if isinstance(v, dict):
            return {k: place(v[k], log[k]) for k in v}
        return placements_for(logical_to_spec(log, v.shape, mesh, rules),
                              mesh)

    return specs, {k: place(specs[k], logical[k]) for k in specs}


def distribute_tree(values, placements, mesh):
    """Zip a tree of tensors with a tree of placements into DTensors
    (`sharding.distribute`)."""
    if isinstance(values, dict):
        return {k: distribute_tree(values[k], placements[k], mesh)
                for k in values}
    if isinstance(values, (list, tuple)):
        items = [distribute_tree(v, p, mesh)
                 for v, p in zip(values, placements)]
        return (type(values)(*items) if hasattr(values, "_fields")
                else type(values)(items))
    return distribute(values, mesh, placements)


# ---------------------------------------------------------------------------
# step functions (closed over cfg)
# ---------------------------------------------------------------------------

def make_train_fn(cfg: ModelConfig, rl: RLConfig = RLConfig(),
                  adam: AdamConfig = AdamConfig(), microbatch: int = 1):
    def fn(state, batch):
        return train_step(state, batch, cfg, rl, adam, microbatch=microbatch)
    return fn


def _greedy(logits):
    """argmax over the vocab of (B, 1, V) logits, the vocab gathered
    first (one row per sequence)."""
    from repro_torch.shardctx import constrain
    return torch.argmax(constrain(logits, ("batch", None, None)), dim=-1)


def make_prefill_fn(cfg: ModelConfig):
    def fn(params, batch):
        with torch.no_grad():
            out = M.forward(params, batch["tokens"], batch["positions"], cfg,
                            prefix_embeds=batch.get("prefix_embeds"),
                            return_cache=True)
        next_tok = _greedy(out["logits"][:, -1:])
        return next_tok, out["cache"]
    return fn


def make_serve_fn(cfg: ModelConfig, ring: bool):
    def fn(params, batch):
        # lockstep decode: one write position for every row
        index = batch["cache_index"].expand(batch["tokens"].shape[0])
        with torch.no_grad():
            out = M.decode_step(params, batch["tokens"], batch["positions"],
                                batch["cache"], index, cfg, ring=ring)
        next_tok = _greedy(out["logits"])
        return next_tok, out["cache"]
    return fn


def weight_update_fn(leaves, placements, mesh):
    """The in-flight weight transfer: each leaf redistributed from the
    trainer layout to the generation layout (a gloo group's gathers go
    through `shardctx.redistribute`)."""
    from repro_torch.shardctx import redistribute
    return [redistribute(x, mesh, p) for x, p in zip(leaves, placements)]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TracedProgram:
    """What one traced step did on one device: the counts `analyze` reads
    and the memory record. Bytes are shard-local."""
    name: str
    n_devices: int
    flops: int
    bytes: int
    coll: Dict[str, int]
    coll_axis: Dict[str, int]
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    n_ops: int
    t_trace_s: float


def group_axes(mesh) -> Dict[str, str]:
    """{process group name: mesh axis} of a DeviceMesh's per-axis groups."""
    return {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    n = 0
    for x in tree_flatten(tree)[0]:
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


def trace(name: str, fn, args: Tuple, mesh, rules=None) -> TracedProgram:
    """Run fn(*args) once on DTensors under the rules, counting."""
    from repro_torch.roofline.analysis import TraceCounter
    from repro_torch.shardctx import sharding_context

    counter = TraceCounter(group_axes(mesh))
    t0 = time.time()
    with sharding_context(mesh, rules), counter:
        out = fn(*args)
    t = time.time() - t0
    return TracedProgram(
        name=name, n_devices=mesh.size(), flops=counter.flops,
        bytes=counter.bytes, coll=dict(counter.coll),
        coll_axis=dict(counter.coll_axis), argument_bytes=_local_bytes(args),
        output_bytes=_local_bytes(out), temp_bytes=counter.peak_live,
        n_ops=counter.n_ops, t_trace_s=t)


def lower_program(arch_cfg: ModelConfig, shape: ShapeSpec, mesh,
                  rules=None, microbatch: int = 1,
                  donate_cache: bool = False) -> TracedProgram:
    """Trace the step program for one (arch, shape) on `mesh`.

    donate_cache is accepted for the JAX signature and recorded by the
    caller: the port's decode writes its cache in place anyway."""
    del donate_cache
    cfg = for_shape(arch_cfg, shape)
    specs, bplace = batch_shardings(cfg, shape, mesh, rules)
    batch = distribute_tree(specs, bplace, mesh)
    name = f"{cfg.name}:{shape.name}"
    if shape.kind == "train":
        ann, state = abstract_train_state(cfg)
        state = distribute_tree(state, state_shardings(ann, mesh, rules),
                                 mesh)
        return trace(name, make_train_fn(cfg, microbatch=microbatch),
                     (state, batch), mesh, rules)
    ann = abstract_params(cfg)
    params = distribute_tree(tree_values(ann),
                              tree_shardings(ann, mesh, rules), mesh)
    if shape.kind == "prefill":
        fn = make_prefill_fn(cfg)
    else:
        fn = make_serve_fn(cfg, cfg.attention_variant == "sliding_window")
    return trace(name, fn, (params, batch), mesh, rules)


def _gen_rules(cfg: ModelConfig):
    # giants (>40B) keep the trainer layout at the generator too
    return GEN_RULES if cfg.param_count() < 40e9 else None


def _update_leaves(arch_cfg: ModelConfig, mesh):
    """(meta leaves, trainer placements, generator placements), in
    `tree_flatten` order."""
    ann = abstract_params(arch_cfg)
    leaves_ann = tree_flatten(ann)[0]
    train = [placements_for(logical_to_spec(a.logical, a.value.shape, mesh),
                            mesh) for a in leaves_ann]
    rules = _gen_rules(arch_cfg)
    gen = [placements_for(logical_to_spec(a.logical, a.value.shape, mesh,
                                          rules), mesh) for a in leaves_ann]
    return [a.value for a in leaves_ann], train, gen


def lower_weight_update(arch_cfg: ModelConfig, mesh, n_chunks: int = 1):
    """Trace the trainer->generator weight transfer. n_chunks=1 returns the
    whole-tree program; n_chunks>1 a list of per-chunk programs over
    contiguous byte-balanced leaf spans (`chunk_spans`), the launcher twin
    of the streamed in-flight broadcast."""
    values, train, gen = _update_leaves(arch_cfg, mesh)

    def program(name, lo, hi):
        src = [distribute(v, mesh, p)
               for v, p in zip(values[lo:hi], train[lo:hi])]
        return trace(name, lambda xs: weight_update_fn(xs, gen[lo:hi], mesh),
                     (src,), mesh)

    if n_chunks <= 1:
        return program(f"{arch_cfg.name}:weight_update", 0, len(values))
    return [program(f"{arch_cfg.name}:weight_update_chunk{i}", lo, hi)
            for i, (lo, hi) in enumerate(chunk_spans(values, n_chunks))]


def execute_weight_update(arch_cfg: ModelConfig, mesh, n_chunks: int = 1,
                          max_bytes: int = 1 << 30) -> List[Dict[str, Any]]:
    """EXECUTE the per-chunk weight-update redistributes on zero-filled
    buffers over a real process group (`mesh` on gloo or NCCL) and time
    each chunk's second run: the runtime companion of
    `lower_weight_update`, whose `t_collective_s` is arithmetic. The model
    must fit: `max_bytes` guards against materializing a dry-run giant.
    Returns one record per chunk: {"chunk", "nbytes", "t_exec_s"}."""
    from torch.distributed.tensor import distribute_tensor

    values, train, gen = _update_leaves(arch_cfg, mesh)
    total = sum(v.numel() * v.element_size() for v in values)
    if total > max_bytes:
        raise ValueError(
            f"{arch_cfg.name}: {total} param bytes exceed the execute budget "
            f"({max_bytes}); pass a smoke config")
    dev = mesh.device_type
    spans = chunk_spans(values, n_chunks)
    sizes = span_bytes(values, spans)
    out = []
    for i, (lo, hi) in enumerate(spans):
        bufs = [distribute_tensor(torch.zeros(v.shape, dtype=v.dtype,
                                              device=dev), mesh, p)
                for v, p in zip(values[lo:hi], train[lo:hi])]
        weight_update_fn(bufs, gen[lo:hi], mesh)        # warm
        synchronize(dev)
        t0 = time.perf_counter()
        res = weight_update_fn(bufs, gen[lo:hi], mesh)
        for r in res:
            r.to_local()
        synchronize(dev)
        out.append({"chunk": i, "nbytes": int(sizes[i]),
                    "t_exec_s": time.perf_counter() - t0})
    return out
