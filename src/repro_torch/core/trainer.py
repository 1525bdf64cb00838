"""Trainer: the π side of PipelineRL (Algorithm 2, Trainer process).

`train_step` is a function of the train state and a packed batch; the
`Trainer` class wraps it with weight-version bookkeeping: each optimizer
step bumps `version`, which is what an in-flight weight update ships to the
generation engine. `Trainer.params` is a tree of plain tensors
(`requires_grad=False`) that an engine may decode with while the trainer
steps: the step computes gradients through leaves it makes from them and
returns new tensors, never writing into the old ones.

Per-step metrics stay on the device: `Trainer.step` returns a
`LazyMetrics` view, and the host reads a record in one device-to-host copy
when (and if) a value is asked for.

`mesh=` places the train state on a `DeviceMesh` (the JAX package's
real-mesh trainer): parameters and both Adam moments in the train layout
of their logical axes (`launch.steps.state_shardings`), the counters
replicated, each rank keeping its own block of the whole state it was
given (no traffic). The step runs under `shardctx.sharding_context`, the
staged batch is replicated on the mesh, and every metric is reduced to a
plain tensor, so the host reads the same value on every rank.
"""
from __future__ import annotations

import contextlib
import functools
from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.algo import RLConfig, reinforce_loss
from repro_torch.core.weights import tree_flatten, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_update, global_norm)
from repro_torch.shardctx import full


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    version: torch.Tensor  # 0-d int32, the number of optimizer steps taken


def _check_device(params, device: torch.device) -> None:
    for leaf in tree_flatten(params)[0]:
        if leaf.device != device:
            raise ValueError(f"params on {leaf.device}, expected {device}")


def init_train_state(params, device="cuda") -> TrainState:
    """Fresh Adam state for `params`, which must already live on `device`
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    _check_device(params, device)
    return TrainState(params=params, opt=adam_init(params),
                      version=torch.zeros((), dtype=torch.int32,
                                          device=device))


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            rl: RLConfig):
    tokens = batch["tokens"]
    kw: Dict[str, Any] = {}
    if cfg.fused_loss:
        # next-token targets: position t holds tokens[t+1]; the last column
        # is dead (nothing to predict) and masked by the loss alignment
        kw["loss_targets"] = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    out = M.forward(params, tokens, batch["positions"], cfg,
                    segment_ids=batch.get("segment_ids"),
                    prefix_embeds=batch.get("prefix_embeds"), **kw)
    if "logits" in out:
        outputs = out["logits"]
    else:  # fused path: per-token stats, no (B,S,V) logits exist
        outputs = {"token_logprobs": out["token_logprobs"],
                   "entropy": out["entropy"]}
    loss, metrics = reinforce_loss(outputs, out.get("values"), batch, rl)
    if cfg.n_experts:
        loss = loss + rl.aux_coef * out["aux_loss"]
        metrics["moe_aux"] = out["aux_loss"]
    metrics["loss"] = loss
    return loss, metrics


def _value_and_grad(params, batch, cfg: ModelConfig, rl: RLConfig):
    """(metrics, gradient leaves in `tree_flatten` order) of `loss_fn`,
    through leaves made from the stored parameters."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(treedef, live), batch, cfg,
                                rl)
        # a leaf the loss does not reach (the MTP head's: its outputs pass
        # through untouched) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return {k: v.detach() for k, v in metrics.items()}, list(grads)


def train_step(state: TrainState, batch, cfg: ModelConfig, rl: RLConfig,
               adam: AdamConfig, microbatch: int = 1, lr_schedule=None,
               guard: bool = False, poison: bool = False,
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step. microbatch > 1 accumulates float32 gradients
    over that many slices of the batch.

    guard=True arms the non-finite check: if the global grad norm or the
    loss is non-finite, the update is dropped on the device (params, moments
    and version keep their old values through `torch.where`, with no host
    sync), and `metrics["nonfinite"]` reports it. `where(False, old, new)`
    returns `new` bitwise, so a guarded healthy step equals an unguarded
    one bit for bit. `poison` replaces the gradients with NaN (fault
    injection), so that the guard is exercised end to end."""
    if microbatch <= 1:
        metrics, grads = _value_and_grad(state.params, batch, cfg, rl)
    else:
        def split(x, i):
            n = x.shape[0] // microbatch
            return x[i * n:(i + 1) * n]

        grads, metrics = None, None
        for i in range(microbatch):
            m, g = _value_and_grad(state.params,
                                   {k: split(v, i) for k, v in batch.items()},
                                   cfg, rl)
            g = [x.float() / microbatch for x in g]
            m = {k: v / microbatch for k, v in m.items()}
            if grads is None:
                grads, metrics = g, m
            else:
                grads = [a + b for a, b in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
    if guard and poison:
        grads = [torch.full_like(g, float("nan")) for g in grads]
    grads = tree_unflatten(tree_flatten(state.params)[1], grads)
    lr = lr_schedule(state.opt.step) if lr_schedule is not None else None
    gnorm = global_norm(grads)
    bad = None
    if guard:
        bad = ~(torch.isfinite(gnorm) & torch.isfinite(metrics["loss"]))
    new_params, new_opt, _ = adam_update(state.params, grads, state.opt,
                                         adam, lr=lr, gnorm=gnorm, bad=bad)
    metrics["grad_norm"] = gnorm
    if lr is not None:
        metrics["lr"] = lr
    if guard:
        metrics["nonfinite"] = bad.float()
        version = state.version + (~bad).to(torch.int32)
    else:
        version = state.version + 1
    return TrainState(new_params, new_opt, version), metrics


def make_train_step(cfg: ModelConfig, rl: RLConfig, adam: AdamConfig,
                    microbatch: int = 1, lr_schedule=None,
                    guard: bool = False):
    return functools.partial(train_step, cfg=cfg, rl=rl, adam=adam,
                             microbatch=microbatch, lr_schedule=lr_schedule,
                             guard=guard)


def _fetch(records: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Every value of every record, in one device-to-host copy."""
    keys = [list(r) for r in records]
    vals = [v.detach().reshape(()).to(torch.float64)
            for r in records for v in r.values()]
    if not vals:
        return [{} for _ in records]
    flat = torch.stack(vals).cpu().tolist()
    out, i = [], 0
    for ks in keys:
        out.append(dict(zip(ks, flat[i:i + len(ks)])))
        i += len(ks)
    return out


class LazyMetrics(Mapping):
    """Device-resident metrics record. Holding one costs no host sync; the
    first key access fetches *all* values in one device-to-host copy and
    keeps them as python floats."""

    def __init__(self, dev: Dict[str, torch.Tensor]):
        self._dev = dev
        self._host: Optional[Dict[str, float]] = None

    def fetch(self) -> Dict[str, float]:
        if self._host is None:
            self._host = _fetch([self._dev])[0]
            self._dev = {}
        return self._host

    def peek(self, k: str) -> float:
        """Fetch ONE metric without materializing the record."""
        if self._host is not None:
            return self._host[k]
        return float(self._dev[k])

    def __getitem__(self, k: str) -> float:
        return self.fetch()[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._host if self._host is not None else self._dev)

    def __len__(self) -> int:
        return len(self._host if self._host is not None else self._dev)

    def __repr__(self) -> str:
        state = "synced" if self._host is not None else "on-device"
        return f"LazyMetrics({state}: {list(self)})"


# batch fields the train step does not consume (bookkeeping riding along
# in pack() output); dropped before staging
_NON_MODEL_KEYS = ("packing_stats", "weight_versions")
# staleness-contract fields: consumed by the loss only when a lag mode is
# armed, dropped otherwise
_LAG_KEYS = ("lag", "truncated")


def _map_leaves(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


class Trainer:
    """Consumes packed batches, performs optimizer steps, exposes the
    current policy weights + version for in-flight updates. Runs on the
    card unless `device="cpu"` is asked for; `params` must already live on
    that device. `mesh`/`rules` place the train state on a DeviceMesh
    (module docstring); `params` are then the whole tensors, the same on
    every rank."""

    def __init__(self, cfg: ModelConfig, params, rl: RLConfig = RLConfig(),
                 adam: AdamConfig = AdamConfig(), lr_schedule=None,
                 guard: bool = True, device="cuda", mesh=None, rules=None):
        self.device = resolve_device(device)
        self.cfg, self.rl, self.adam = cfg, rl, adam
        self.mesh, self.rules = mesh, rules
        self.state = self._placed(init_train_state(params,
                                                   device=self.device))
        self.guard = bool(guard)
        self.nonfinite_steps = 0   # updates dropped by the in-step guard
        self._step = make_train_step(cfg, rl, adam, lr_schedule=lr_schedule,
                                     guard=self.guard)
        self.history: List[LazyMetrics] = []

    def _placed(self, state: TrainState) -> TrainState:
        """`state` (whole tensors) in the train layout on the mesh; as it
        is without one."""
        if self.mesh is None:
            return state
        from repro_torch.launch.steps import (abstract_train_state,
                                              distribute_tree,
                                              state_shardings)
        ann, _ = abstract_train_state(self.cfg)
        return distribute_tree(state, state_shardings(ann, self.mesh,
                                                      self.rules), self.mesh)

    def _ctx(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.shardctx import sharding_context
        return sharding_context(self.mesh, self.rules)

    @property
    def version(self) -> int:
        return int(full(self.state.version))

    @property
    def params(self):
        return self.state.params

    def _stage(self, batch) -> Dict[str, torch.Tensor]:
        """Host numpy fields onto the device (integers as int64); tensors
        already there are used as they are."""
        out = {}
        for k, v in batch.items():
            if not isinstance(v, torch.Tensor):
                a = np.asarray(v)
                v = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                                     else a)
            v = v.to(self.device, non_blocking=True)
            if self.mesh is not None:
                from torch.distributed.tensor import DTensor, Replicate
                v = DTensor.from_local(v, self.mesh,
                                       [Replicate()] * self.mesh.ndim,
                                       run_check=False)
            out[k] = v
        return out

    def step(self, batch, poison: bool = False) -> LazyMetrics:
        """One optimizer step on a packed batch (host numpy, the pack()
        output, or tensors on the device). Returns a `LazyMetrics` view;
        nothing syncs to the host unless a metric is read. `poison` (guard
        mode only) injects NaN gradients; the guard must catch them."""
        drop = _NON_MODEL_KEYS if self.rl.lag_mode != "off" \
            else _NON_MODEL_KEYS + _LAG_KEYS
        batch = self._stage({k: v for k, v in batch.items()
                             if k not in drop})
        with self._ctx():
            if self.guard:
                self.state, metrics = self._step(self.state, batch,
                                                 poison=poison)
            else:
                self.state, metrics = self._step(self.state, batch)
            if self.mesh is not None:
                metrics = {k: full(v) for k, v in metrics.items()}
        m = LazyMetrics(metrics)
        self.history.append(m)
        return m

    def last_nonfinite(self) -> bool:
        """Guard verdict of the newest step: did the non-finite check drop
        the update? One scalar `peek`, not a full sync."""
        if not self.guard or not self.history:
            return False
        bad = self.history[-1].peek("nonfinite") > 0.0
        if bad:
            self.nonfinite_steps += 1
        return bad

    # ---- crash-restart checkpointing -----------------------------------
    def save(self, path: str) -> str:
        """Atomic checkpoint of the full TrainState (params, optimizer
        moments, version), in the JAX package's keys."""
        from repro_torch.checkpoint import checkpoint
        if self.mesh is None:
            checkpoint.save(path, self.state)
            return checkpoint._norm(path)
        # on a mesh the state is gathered whole and its first rank writes
        # it; every rank leaves once the file is in place
        import torch.distributed as dist
        whole = _map_leaves(full, self.state)
        if dist.get_rank() == int(self.mesh.mesh.reshape(-1)[0]):
            checkpoint.save(path, whole)
        dist.barrier()
        return checkpoint._norm(path)

    def restore(self, path: str) -> int:
        """Restore params, optimizer state and version from `path`; returns
        the restored version. The next `step` is then the one an
        uninterrupted run would have taken on the same batch."""
        from repro_torch.checkpoint import checkpoint
        if self.mesh is None:
            self.state = checkpoint.load(path, self.state)
            return self.version
        like = _map_leaves(lambda x: torch.empty(
            x.shape, dtype=x.dtype, device=self.device), self.state)
        self.state = self._placed(checkpoint.load(path, like))
        return self.version

    def fetch_metrics(self) -> List[Dict[str, float]]:
        """Materialize the whole history in one device-to-host copy."""
        pending = [m for m in self.history if m._host is None]
        if pending:
            for m, h in zip(pending, _fetch([m._dev for m in pending])):
                m._host = h
                m._dev = {}
        return [m.fetch() for m in self.history]
