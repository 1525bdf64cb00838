"""Calibrated roofline: the JAX package's extrapolation from per-group
layer counts 1 and 2.

XLA's cost_analysis counts a `lax.scan` body once, so the JAX package
compiles the layer scans unrolled at per-group layer counts 1 and 2:

    body_g   = f(counts with g=2) - f(counts all 1)
    outside  = f(all 1) - sum_g body_g
    total(L) = outside + sum_g L_g * body_g

The port traces an eager Python loop over the layers, so nothing is
scan-blind: the calibrated total equals the direct trace of the full
config, and a test holds that law. Gradient-accumulation microbatch loops
are calibrated at mb=1 (FLOPs are mb-invariant; HBM bytes gain (mb-1)
weight re-reads, approximated analytically, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeSpec, for_shape
from repro_torch.models.model import layer_groups
from repro_torch.roofline.analysis import (Roofline, analyze,
                                           model_flops_estimate)


def _with_group_counts(cfg: ModelConfig, counts) -> ModelConfig:
    groups = layer_groups(cfg)
    assert len(counts) == len(groups)
    total = sum(counts)
    if cfg.n_experts and cfg.n_dense_layers:
        return dataclasses.replace(cfg, n_layers=total,
                                   n_dense_layers=counts[0])
    return dataclasses.replace(cfg, n_layers=total)


def _measure(cfg: ModelConfig, shape: ShapeSpec, mesh,
             rules=None) -> Dict[str, float]:
    from repro_torch.launch.steps import lower_program
    prog = lower_program(cfg, shape, mesh, microbatch=1, rules=rules)
    r = analyze(prog.name, prog, mesh.size())
    out = {"flops": r.flops, "bytes": r.bytes_accessed, "coll": r.coll_bytes}
    out.update({f"axis:{k}": float(v) for k, v in r.coll_axis.items()})
    return out


def calibrated_roofline(arch_cfg: ModelConfig, shape: ShapeSpec, mesh,
                        microbatch: int = 1,
                        mem_bytes_per_device: float = 0.0,
                        rules=None) -> Roofline:
    cfg = for_shape(arch_cfg, shape)
    groups = layer_groups(cfg)
    n_groups = len(groups)
    real_counts = [c for _, c in groups]

    base = _measure(_with_group_counts(cfg, [1] * n_groups), shape, mesh,
                    rules=rules)
    bodies = []
    for g in range(n_groups):
        counts = [1] * n_groups
        counts[g] = 2
        inc = _measure(_with_group_counts(cfg, counts), shape, mesh,
                       rules=rules)
        keys = set(base) | set(inc)
        bodies.append({k: inc.get(k, 0.0) - base.get(k, 0.0) for k in keys})

    keys = set(base).union(*bodies) if bodies else set(base)
    outside = {k: base.get(k, 0.0) - sum(b.get(k, 0.0) for b in bodies)
               for k in keys}
    tot = dict(outside)
    for g in range(n_groups):
        for k in tot:
            tot[k] += real_counts[g] * bodies[g].get(k, 0.0)

    if microbatch > 1:
        # weight re-reads: each extra microbatch re-streams the (sharded)
        # parameters from HBM for forward+backward (~3 reads of 2 bytes)
        w_bytes_dev = cfg.param_count() * 2 / mesh.size()
        tot["bytes"] += (microbatch - 1) * 3.0 * w_bytes_dev
        # FSDP weight all-gathers repeat per microbatch: approximate with
        # the weight bytes gathered over "data"
        tot["coll"] += (microbatch - 1) * w_bytes_dev
        tot["axis:data"] = tot.get("axis:data", 0.0) + \
            (microbatch - 1) * w_bytes_dev

    return Roofline(
        name=f"{cfg.name}:{shape.name}:calibrated(mb={microbatch})",
        flops=tot["flops"], bytes_accessed=tot["bytes"],
        coll_bytes=tot["coll"], coll_breakdown={},
        n_devices=mesh.size(),
        model_flops=model_flops_estimate(cfg, shape),
        bytes_per_device=mem_bytes_per_device,
        coll_axis={k[5:]: v for k, v in tot.items() if k.startswith("axis:")},
    )
