"""Two gloo ranks on the CPU for `tests/test_torch_sharded.py`.

    python tests/torch_sharded_worker.py INPUTS.pkl OUT_DIR

INPUTS.pkl holds numpy arrays and parameter trees drawn by the test. The
script spawns two ranks on one process group (a ("model",) mesh of 2),
runs the port's vocab-parallel fused loss, the model's fused loss under
`sharding_context`, expert-parallel `moe_apply` and
`execute_weight_update`, and each rank writes what it saw to
OUT_DIR/rank{r}.pt. It imports the port only.
"""
import dataclasses
import os
import pickle
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaf(x, mesh, placements):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x.detach(), mesh, placements).requires_grad_(True)


def _scalar(lp, lse, ent):
    return (lp * 1.3 - 0.7 * lse + 0.11 * ent).sum()


def _kernel_level(inp, mesh):
    """fused_logprob_sharded on a vocab-split head: values and gradients
    to hidden and head, through all three outputs."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.sharded import fused_logprob_sharded

    out = {}
    for tied in (False, True):
        c = inp["loss"][tied]
        h = _leaf(_t(c["h"]), mesh, [Replicate()])
        w = _leaf(_t(c["w"]), mesh, [Shard(0 if tied else 1)])
        t = _t(c["t"])
        lp, lse, ent = fused_logprob_sharded(h, w, t, mesh=mesh,
                                             transpose_head=tied)
        loss = _scalar(lp, lse, ent)
        loss.backward()
        out[tied] = {"value": loss.full_tensor().item(),
                     "stats": [x.full_tensor().detach().numpy() for x in (lp, lse, ent)],
                     "dh": h.grad.full_tensor().numpy(),
                     "dw": w.grad.full_tensor().numpy(),
                     "local_w": tuple(w.to_local().shape)}
    return out


def _model_level(inp, mesh):
    """The model's fused loss under sharding_context, every parameter
    placed by the rules (tensor parallel over "model"): the per-token stats
    and the gradients of the embedding and the head."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.weights import tree_flatten
    from repro_torch.models import model as M
    from repro_torch.sharding import logical_to_spec, placements_for
    from repro_torch.shardctx import sharding_context

    out = {}
    for key, c in inp["model"].items():
        arch, tied = key
        cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                  fused_loss=True, tie_embeddings=tied,
                                  **c["overrides"])
        params = params_from_numpy(c["tree"], cfg, device="cpu")
        logical = M.param_logical(cfg)

        def place(p, log):
            if isinstance(p, dict):
                return {k: place(p[k], log[k]) for k in p}
            if isinstance(p, list):
                return [place(a, b) for a, b in zip(p, log)]
            return _leaf(p, mesh, placements_for(
                logical_to_spec(log, p.shape, mesh), mesh))

        dp = place(params, logical)
        toks, pos = _t(c["tokens"]), _t(c["positions"])
        tgt = torch.cat([toks[:, 1:], toks[:, -1:]], dim=1)
        with sharding_context(mesh):
            o = M.forward(dp, toks, pos, cfg, loss_targets=tgt)
            loss = _scalar(o["token_logprobs"], o["lse"], o["entropy"])
            loss.backward()
        head = dp["embed"] if tied else dp["lm_head"]
        out[key] = {"value": loss.full_tensor().item(),
                    "stats": [o[k].full_tensor().detach().numpy() for k in
                              ("token_logprobs", "lse", "entropy")],
                    # a leaf the loss does not reach (the value head) has
                    # no gradient: zeros, as under jax.grad
                    "grads": [np.zeros(g.shape, np.float32) if g.grad is None
                              else g.grad.full_tensor().numpy()
                              for g in tree_flatten(dp)[0]],
                    "head_local": tuple(head.to_local().shape)}
    return out


def _moe_level(inp, mesh):
    """Expert-parallel moe_apply: output, aux loss, gradients, and the
    routing decisions of each rank against the unsharded port."""
    from torch.distributed.tensor import Replicate

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import moe as TMoE
    from repro_torch.shardctx import sharding_context

    out = {}
    for cf, c in inp["moe"].items():
        cfg = dataclasses.replace(smoke_config(get_config(
            "granite-moe-1b-a400m")), capacity_factor=cf, **c["overrides"])
        w = {k: _t(v) for k, v in c["w"].items()}
        x = _t(c["x"])
        r = _t(c["r"])
        dw = {k: _leaf(v, mesh, [Replicate()]) for k, v in w.items()}
        dx = _leaf(x, mesh, [Replicate()])
        with sharding_context(mesh):
            o, aux = TMoE.moe_apply(dw, dx, cfg)
            ((o * r).sum() + 0.5 * aux).backward()
        lw = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        lx = x.clone().requires_grad_(True)
        o1, aux1 = TMoE.moe_apply(lw, lx, cfg)
        ((o1 * r).sum() + 0.5 * aux1).backward()
        # this rank's routing decisions, mapped to global (expert, slot)
        T = x.shape[0] * x.shape[1]
        C = TMoE._capacity(T, cfg)
        probs = torch.softmax(x.reshape(T, -1).float() @ w["router"], -1)
        ep = mesh.size(0)
        n_local = cfg.n_experts // ep
        off = mesh.get_local_rank("model") * n_local
        d_ep, _ = TMoE.route(probs, cfg, C, n_local, off)
        d_all, _ = TMoE.route(probs, cfg, C, cfg.n_experts, 0)
        out[cf] = {
            "out": o.full_tensor().detach().numpy(),
            "aux": float(aux.full_tensor()),
            "out_single": o1.detach().numpy(), "aux_single": float(aux1),
            "grads": {k: v.grad.full_tensor().numpy() for k, v in dw.items()},
            "grads_single": {k: v.grad.numpy() for k, v in lw.items()},
            "dx": dx.grad.full_tensor().numpy(), "dx_single": lx.grad.numpy(),
            "capacity": C, "offset": off, "n_local": n_local,
            "dests_ep": [d.numpy() for d in d_ep],
            "dests_all": [d.numpy() for d in d_all],
        }
    return out


def _weight_update(mesh_data):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.steps import execute_weight_update

    return execute_weight_update(smoke_config(get_config("granite-3-2b")),
                                 mesh_data, n_chunks=3)


def _rank(rank, port, inputs, out_dir):
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        mesh = DeviceMesh("cpu", torch.arange(WORLD),
                          mesh_dim_names=("model",))
        res = {"loss": _kernel_level(inp, mesh),
               "model": _model_level(inp, mesh),
               "moe": _moe_level(inp, mesh)}
        mesh_data = DeviceMesh("cpu", torch.arange(WORLD),
                               mesh_dim_names=("data",))
        res["weight_update"] = _weight_update(mesh_data)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    mp.spawn(_rank, args=(_free_port(), sys.argv[1], sys.argv[2]),
             nprocs=WORLD, join=True)
