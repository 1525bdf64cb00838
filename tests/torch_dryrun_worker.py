"""The dry-run checks of `tests/test_torch_dryrun.py` that need the fake
process group, run in one process of their own (the group is
process-global):

    python tests/torch_dryrun_worker.py OUT.json

It imports the port only and writes one JSON record per check.
"""
import dataclasses
import json
import sys

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import steps
from repro_torch.launch.dryrun import run_disaggregated
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.roofline.calibrate import calibrated_roofline
from repro_torch.roofline.analysis import analyze
from repro_torch.sharding import distribute, logical_to_spec


def weight_update_bytes():
    """Traced collective bytes of the granite weight update, whole and per
    axis, beside the analytic count: for each leaf, the mesh axes whose
    shard the generation rules drop are gathered innermost first, each
    gather writing the leaf's local bytes after it."""
    mesh = make_production_mesh()
    cfg = get_config("granite-3-2b")
    prog = steps.lower_weight_update(cfg, mesh)
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    want = {}
    for a in steps.tree_flatten(steps.abstract_params(cfg))[0]:
        shape = a.value.shape
        src = logical_to_spec(a.logical, shape, mesh)
        dst = logical_to_spec(a.logical, shape, mesh, steps.GEN_RULES)
        local = a.value.numel() * a.value.element_size()
        held = {ax for e in src if e for ax in ((e,) if isinstance(e, str)
                                                else e)}
        for ax in held:
            local //= sizes[ax]
        kept = {ax for e in dst if e for ax in ((e,) if isinstance(e, str)
                                                else e)}
        for ax in reversed(names):
            if ax in held and ax not in kept:
                local *= sizes[ax]
                want[ax] = want.get(ax, 0) + local
    return {"traced": prog.coll_axis, "analytic": want,
            "kinds": {k: v for k, v in prog.coll.items() if v}}


def smoke_forward_flops():
    """One device: the traced FLOPs of a smoke granite prefill forward and
    the hand count of its products."""
    fake_world(1)
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    cfg = smoke_config(get_config("granite-3-2b"))
    shape = ShapeSpec("smoke", 128, 2, "prefill")
    prog = steps.lower_program(cfg, shape, mesh)
    T = shape.global_batch * shape.seq_len
    d, H, KV, Dh, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, cfg.d_ff, cfg.vocab_size)
    per_layer = (2 * T * d * H * Dh * 2          # q and o
                 + 2 * T * d * KV * Dh * 2       # k and v
                 + 2 * T * d * ff * 3            # gate, up, down
                 # the plain attention: full (S, S) scores and PV
                 + 2 * shape.global_batch * H * shape.seq_len ** 2 * Dh * 2)
    hand = cfg.n_layers * per_layer + 2 * T * d * V + 2 * T * d * 1
    return {"traced": prog.flops, "hand": hand}


def product_split():
    """(M,K) x (K,N) with x split over "data" and w over "model": the
    per-device count times the devices equals the global count."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_production_mesh()
    M_, K, N = 4096, 2048, 8192
    x = distribute(torch.empty(M_, K, dtype=torch.bfloat16, device="meta"),
                   mesh, [Shard(0), Replicate()])
    w = distribute(torch.empty(K, N, dtype=torch.bfloat16, device="meta"),
                   mesh, [Replicate(), Shard(1)])
    prog = steps.trace("mm", lambda a, b: a @ b, (x, w), mesh)
    return {"per_device": prog.flops, "devices": mesh.size(),
            "global": 2 * M_ * K * N, "coll": sum(prog.coll.values())}


def calibrated_vs_direct():
    """The layer-count extrapolation against the direct trace, for a
    two-group MoE config (leading dense layers) and a dense one."""
    mesh = make_production_mesh()
    out = {}
    for arch, layers, shape in (
            ("granite-3-2b", 5, ShapeSpec("t", 256, 32, "train")),
            ("deepseek-v3-671b", 4, ShapeSpec("d", 512, 32, "decode"))):
        cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                  n_layers=layers)
        direct = analyze("d", steps.lower_program(cfg, shape, mesh),
                         mesh.size())
        cal = calibrated_roofline(cfg, shape, mesh)
        out[arch] = {"direct": [direct.flops, direct.bytes_accessed,
                                direct.coll_bytes],
                     "calibrated": [cal.flops, cal.bytes_accessed,
                                    cal.coll_bytes]}
    return out


if __name__ == "__main__":
    res = {"weight_update": weight_update_bytes(),
           "smoke_forward": smoke_forward_flops(),
           "product": product_split(),
           "calibrated": calibrated_vs_direct()}
    rec = run_disaggregated("granite-3-2b")
    res["disaggregated"] = {k: rec.get(k) for k in
                            ("ok", "error", "train_mesh", "gen_mesh")}
    res["disaggregated"]["terms"] = {
        k: rec[k]["t_compute_s"] for k in ("train", "serve") if k in rec}
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)
