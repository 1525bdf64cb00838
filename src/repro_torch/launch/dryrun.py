"""Dry-run: trace every (architecture x input shape) on the production
meshes and record memory, cost and collective analysis.

  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]

This is the proof that the distribution config is coherent without the
cluster: each step runs once, eagerly, on meta DTensors over a fake
process group of 128 (or 256) ranks, one process standing for rank 0. A
sharding rule DTensor lacks, an op that needs data (`.item()` on the
traced path) or a shape mismatch fails here. No device is used.

`memory_analysis` gives `argument_gb` and `output_gb` exactly, from the
shard-local bytes of the step's inputs and outputs; `temp_gb` is the
largest sum of live shard-local op outputs seen during the trace (each
output counted from its creation until its Python object dies), and
`peak_gb` is argument + temp. Kernels take their plain versions' shapes
and work on meta tensors, as the JAX dry-run lowers with use_pallas off.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import SHAPES, all_configs, get_config
from repro_torch.configs.base import for_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (GEN_RULES, lower_program,
                                      lower_weight_update)
from repro_torch.roofline.analysis import analyze, model_flops_estimate

ARCH_IDS = tuple(all_configs())


def _memory(prog) -> dict:
    return {"argument_gb": prog.argument_bytes / 1e9,
            "output_gb": prog.output_bytes / 1e9,
            "temp_gb": prog.temp_bytes / 1e9,
            "peak_gb": (prog.argument_bytes + prog.temp_bytes) / 1e9}


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            include_weight_update: bool = False, calibrated: bool = False,
            optimized: bool = False, wu_chunks: int = 0,
            wu_execute: bool = False) -> dict:
    """optimized=True applies remat + microbatch=16 for train shapes,
    GEN_RULES (under 40 B parameters) and cache donation for inference
    shapes. calibrated=True replaces the direct terms with the
    layer-count extrapolation (`roofline.calibrate`)."""
    from repro_torch.roofline.calibrate import calibrated_roofline

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mesh.mesh.shape)), "ok": False,
           "optimized": optimized, "calibrated": calibrated}
    rules = None
    lower_kw = {}
    microbatch = 1
    if optimized:
        if shape.kind == "train":
            cfg = dataclasses.replace(cfg, remat=True)
            microbatch = 16
            lower_kw["microbatch"] = 16
        else:
            if cfg.param_count() < 40e9:
                rules = GEN_RULES
                lower_kw["rules"] = GEN_RULES
            lower_kw["donate_cache"] = True
            rec["donate_cache"] = True
    t0 = time.time()
    try:
        prog = lower_program(cfg, shape, mesh, **lower_kw)
        t_trace = time.time() - t0
        if calibrated:
            roof = calibrated_roofline(
                cfg, shape, mesh, microbatch=microbatch, rules=rules,
                mem_bytes_per_device=float(prog.argument_bytes
                                           + prog.temp_bytes))
            if rules is not None:
                roof.name += ":gen_rules"
        else:
            roof = analyze(prog.name, prog, n_dev,
                           model_flops_estimate(for_shape(cfg, shape), shape))
        rec.update(ok=True, t_trace_s=round(t_trace, 1),
                   n_ops=prog.n_ops, **roof.row())
        rec["coll_axis"] = dict(roof.coll_axis)
        rec["memory_analysis"] = _memory(prog)
        if include_weight_update or wu_chunks > 1:
            wu = lower_weight_update(cfg, mesh)
            rec["weight_update"] = analyze(wu.name, wu, n_dev).row()
        if wu_chunks > 1:
            # the streamed in-flight broadcast's launcher twin: per-chunk
            # redistributes over contiguous byte-balanced leaf spans
            chunk_rows = [analyze(p.name, p, n_dev).row()
                          for p in lower_weight_update(cfg, mesh,
                                                       n_chunks=wu_chunks)]
            rec["weight_update_chunks"] = {
                "n_chunks_requested": wu_chunks,
                "n_chunks": len(chunk_rows),
                "chunks": chunk_rows,
                "sum_coll_gbytes_per_dev": sum(
                    c["coll_gbytes_per_dev"] for c in chunk_rows),
                "sum_t_collective_s": sum(
                    c["t_collective_s"] for c in chunk_rows),
                "max_chunk_t_collective_s": max(
                    (c["t_collective_s"] for c in chunk_rows), default=0.0),
            }
            if wu_execute:
                # the same chunks on zero-filled buffers over a real
                # process group: only configs that fit execute; the byte
                # guard turns a giant into an error record
                from repro_torch.launch.steps import execute_weight_update
                try:
                    execd = execute_weight_update(cfg, _real_mesh(),
                                                  n_chunks=wu_chunks)
                    rec["weight_update_chunks"]["executed"] = execd
                    rec["weight_update_chunks"]["sum_t_exec_s"] = sum(
                        c["t_exec_s"] for c in execd)
                except ValueError as e:
                    rec["weight_update_chunks"]["executed_error"] = str(e)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["t_total_s"] = round(time.time() - t0, 1)
    return rec


def _real_mesh():
    """A one-rank gloo mesh of this process (the fake group replaced):
    where `--wu-execute` runs its chunks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method="tcp://localhost:0",
                            rank=0, world_size=1)
    return DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))


def run_disaggregated(arch: str, n_train_model: int = 4) -> dict:
    """The paper's T-vs-(N-T) resource split as meshes: trace train_step on
    the trainer submesh and serve_step on the generator submesh. This
    process stands for the first rank of each submesh in turn."""
    from repro_torch.launch.mesh import (disaggregated_ranks,
                                         make_disaggregated_meshes)

    full = make_production_mesh()
    train_ranks, gen_ranks = disaggregated_ranks(full, n_train_model)
    cfg = get_config(arch)
    rec = {"arch": arch, "train_mesh": str(tuple(train_ranks.shape)),
           "gen_mesh": str(tuple(gen_ranks.shape)), "ok": False}
    t0 = time.time()
    try:
        train_mesh, _ = make_disaggregated_meshes(full, n_train_model)
        tp = lower_program(cfg, SHAPES["train_4k"], train_mesh)
        rec["train"] = analyze(tp.name, tp, train_mesh.size()).row()
        full = make_production_mesh(rank=int(gen_ranks.reshape(-1)[0]))
        _, gen_mesh = make_disaggregated_meshes(full, n_train_model)
        gp = lower_program(cfg, SHAPES["decode_32k"], gen_mesh,
                           rules=GEN_RULES, donate_cache=True)
        rec["serve"] = analyze(gp.name, gp, gen_mesh.size()).row()
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        make_production_mesh()          # this process is rank 0 again
    rec["t_total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--weight-update", action="store_true")
    ap.add_argument("--wu-chunks", type=int, default=0,
                    help="also trace the weight update as N>=2 per-chunk "
                         "redistributes (the streamed broadcast's launcher "
                         "twin) and record per-chunk collective cost next "
                         "to the whole-tree program (implies the "
                         "whole-tree --weight-update record)")
    ap.add_argument("--wu-execute", action="store_true",
                    help="with --wu-chunks: EXECUTE the per-chunk "
                         "redistributes on zero-filled buffers over a real "
                         "one-rank process group and record measured "
                         "t_exec_s (needs the params to fit)")
    ap.add_argument("--calibrated", action="store_true",
                    help="layer-count-extrapolated roofline terms "
                         "(extra traces)")
    ap.add_argument("--optimized", action="store_true",
                    help="remat+microbatch for train, GEN_RULES for "
                         "inference")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.wu_chunks == 1 or args.wu_chunks < 0:
        ap.error("--wu-chunks must be >= 2 (1 chunk IS the whole-tree "
                 "program; use --weight-update for that)")

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        combos = [(args.arch, args.shape)]

    results = []
    for arch, shape in combos:
        rec = run_one(arch, shape, multi_pod=args.multi_pod,
                      include_weight_update=args.weight_update,
                      calibrated=args.calibrated, optimized=args.optimized,
                      wu_chunks=args.wu_chunks, wu_execute=args.wu_execute)
        status = "OK " if rec["ok"] else "FAIL"
        print(f"[{status}] {arch:24s} {shape:12s} mesh={rec['mesh']} "
              f"t={rec['t_total_s']}s "
              + (f"bottleneck={rec.get('bottleneck')}" if rec["ok"]
                 else rec.get("error", "")), flush=True)
        results.append(rec)
        if args.out:
            _write(args.out, results)

    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} combinations traced")
    if n_ok < len(results):
        raise SystemExit(1)


def _write(path: str, results) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=str)


if __name__ == "__main__":
    main()
