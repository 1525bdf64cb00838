"""Weights across the two packages: the JAX package's param tree as numpy
arrays in, the port's tree of tensors out, and back.

Both trees have the same layout, leaf for leaf: `embed (V,d)`, stacked
layers under `groups[i]` (`wq (L,d,H,Dh)`, `wo (L,H,Dh,d)`, or MLA's `wq_a`,
`wkv_a`, `wk_b`, ...; `ffn.gate/up/down` or `moe`, norms), `lm_head (d,V)`
unless tied, `value_head (d,1)` in float32, `mtp` (DeepSeek-V3's MTP head).
bfloat16 arrays are carried by their bits (numpy has no bfloat16 of its
own; `params_to_numpy` returns `ml_dtypes.bfloat16` arrays for them).
A train state converts the same way: params, the Adam step and float32
moments `m`, `v` in the params' layout, and the version. A generation
engine's state converts too (`engine_state_to_numpy`,
`engine_state_from_numpy`): the device state under the JAX engine's keys
(token buffer, logprobs, counters, the slot cache or the page pools), the
host mirrors and, paged, the block table, the page refcounts and the free
list, so two engines can start from the same paged state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import param_shapes


def _to_tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        # a copy: the tensor must not share (possibly read-only) memory
        # with the caller's array
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def _tree_from_numpy(tree, cfg: ModelConfig, device, dtype=None):
    """The params walk of `params_from_numpy`; `dtype` overrides every
    leaf's dtype (the float32 Adam moments)."""
    def walk(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                raise ValueError(f"{path or 'params'}: keys "
                                 f"{sorted(node) if isinstance(node, dict) else type(node)}"
                                 f" != {sorted(spec)}")
            return {k: walk(node[k], spec[k], f"{path}/{k}") for k in spec}
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(spec):
                raise ValueError(f"{path}: expected a list of {len(spec)}")
            return [walk(n, s, f"{path}[{i}]")
                    for i, (n, s) in enumerate(zip(node, spec))]
        shape, leaf_dtype, _ = spec
        if tuple(np.shape(node)) != tuple(shape):
            raise ValueError(f"{path}: shape {np.shape(node)} != {shape}")
        return _to_tensor(node, dtype or leaf_dtype, device)

    return walk(tree, param_shapes(cfg), "")


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """Map a numpy param tree in the JAX layout onto `device` (the card
    unless the caller asks for the CPU), in the config's dtypes. Raises on
    a missing or extra leaf or a shape mismatch."""
    return _tree_from_numpy(tree, cfg, resolve_device(device))


def _field(node, name: str):
    """`node.name` of a NamedTuple (the JAX TrainState as numpy) or
    `node[name]` of a dict."""
    return node[name] if isinstance(node, dict) else getattr(node, name)


def train_state_from_numpy(state, cfg: ModelConfig, device="cuda"):
    """A train state (the JAX package's `TrainState` with numpy leaves, or
    the dict `train_state_to_numpy` returns) as the port's `TrainState` on
    `device` (the card unless the caller asks for the CPU)."""
    from repro_torch.core.trainer import TrainState
    from repro_torch.optim.adam import AdamState
    device = resolve_device(device)
    opt = _field(state, "opt")

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=device)

    return TrainState(
        params=_tree_from_numpy(_field(state, "params"), cfg, device),
        opt=AdamState(
            step=scalar(_field(opt, "step")),
            m=_tree_from_numpy(_field(opt, "m"), cfg, device, torch.float32),
            v=_tree_from_numpy(_field(opt, "v"), cfg, device, torch.float32)),
        version=scalar(_field(state, "version")))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params) -> Any:
    """The inverse of `params_from_numpy`: a numpy tree in the JAX layout."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return _to_numpy(params)


def train_state_to_numpy(state) -> dict:
    """The inverse of `train_state_from_numpy`: {"params", "opt": {"step",
    "m", "v"}, "version"} with numpy leaves in the JAX layout."""
    return {"params": params_to_numpy(state.params),
            "opt": {"step": _to_numpy(state.opt.step),
                    "m": params_to_numpy(state.opt.m),
                    "v": params_to_numpy(state.opt.v)},
            "version": _to_numpy(state.version)}


# host-side fields of an engine's state, by their attribute names
_ENGINE_HOST = ("_host_active", "_host_ncached", "_host_prompt_len",
                "ver_buf")
_ENGINE_DEVICE = ("tokens", "lp", "n_cached", "prompt_len", "active")


def engine_state_to_numpy(engine) -> dict:
    """A `GenerationEngine`'s state as numpy: {"state": {tokens, lp,
    n_cached, prompt_len, active, cache: {k, v | c_kv, k_rope | conv, ssd}},
    "host": {_host_active,
    _host_ncached, _host_prompt_len, ver_buf}, and, paged, "table",
    "refcount", "free" (the allocator's free list, in its order)}."""
    st = engine.state
    out = {"state": {k: _to_numpy(st[k]) for k in _ENGINE_DEVICE},
           "host": {k: np.array(getattr(engine, k)) for k in _ENGINE_HOST}}
    out["state"]["cache"] = {k: _to_numpy(v) for k, v in st["cache"].items()}
    if engine.tables is not None:
        out.update(table=engine.tables.table.copy(),
                   refcount=engine.allocator.refcount.copy(),
                   free=list(engine.allocator._free))
    return out


def engine_state_from_numpy(engine, state: dict) -> None:
    """Load `state` (the layout of `engine_state_to_numpy`; the JAX
    engine's arrays give the same) into `engine`, in place: every device
    tensor keeps its dtype and device, and a paged engine's allocator and
    block table take the given refcounts, free list and table, then are
    cross-checked."""
    st = engine.state
    src = state["state"]
    for k in _ENGINE_DEVICE:
        st[k].copy_(_to_tensor(src[k], st[k].dtype, st[k].device))
    for k, pool in st["cache"].items():
        pool.copy_(_to_tensor(src["cache"][k], pool.dtype, pool.device))
    for k in _ENGINE_HOST:
        getattr(engine, k)[...] = np.asarray(state["host"][k])
    if engine.tables is not None:
        engine.tables.table[...] = np.asarray(state["table"])
        engine.allocator.refcount[...] = np.asarray(state["refcount"])
        engine.allocator._free = [int(p) for p in state["free"]]
        engine.tables.check()
        engine._bt_dirty = True
        engine._sync_tables()
