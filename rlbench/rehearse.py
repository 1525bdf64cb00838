"""A cell's logic at a tiny size on the CPU, for the tests: the same
drivers, reference and readers on a two-layer model of the cell's
configuration with the kernels' plain versions. Measures nothing."""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Dict

import torch

from rlbench import arch


def tiny_config(c: Dict) -> Dict:
    """Configuration `c` (as run) at its architecture's tiny size (`TINY`),
    in float32."""
    return dict(c, **arch.of(c).TINY, torch_dtype="float32")


@contextlib.contextmanager
def tiny_port(t: Dict):
    """Inside the block the port's `get_config` gives every architecture
    with the fields that the tiny configuration `t` sizes (its
    architecture's `PORT_FIELDS` whose file keys are in `TINY`) at `t`'s
    values."""
    import repro_torch
    a = arch.of(t)
    shrink = {f: t[k] for f, k in a.PORT_FIELDS.items() if k in a.TINY}

    def make(raw):
        return lambda name: dataclasses.replace(raw(name), **shrink)

    with patched(repro_torch, "get_config", make):
        yield


def tiny_loop_traffic(t: Dict) -> Dict:
    t = copy.deepcopy(t)
    t["prompts"].update(len_min=6, len_max=14, len_grid=5)
    t["engine"].update(n_slots=8, max_len=32, prefill_chunk=8, page_size=8)
    t["pipeline"].update(batch_size=8, pack_rows=2, pack_seq=128)
    t["check"].update(sample_groups=2)
    t["prompts"]["group"] = 4
    # a tiny model's losses are small at the mix's learning rate; a larger
    # one brings them to the full model's scale after a few steps
    t["adam"]["lr"] = 0.02
    return t


def tiny_train_traffic(t: Dict) -> Dict:
    t = copy.deepcopy(t)
    t["rollouts"].update(group=4, length=32, len_min=6, len_max=14,
                         len_grid=5)
    t["pack"].update(rows=4, seq=64)
    return t


def tiny_rollout_traffic(t: Dict) -> Dict:
    t = copy.deepcopy(t)
    t["prompts"].update(len_min=6, len_max=14, len_grid=5, group=4)
    t["engine"].update(n_slots=8, max_len=32, prefill_chunk=8, page_size=8)
    t.update(batch_size=8, traced_batches=1)
    return t


TINY_TRAFFIC = {"loop": tiny_loop_traffic, "rollout": tiny_rollout_traffic,
                "train": tiny_train_traffic}


@contextlib.contextmanager
def patched(module, name: str, make):
    """`module.name` replaced by `make(original)` inside the block."""
    raw = getattr(module, name)
    setattr(module, name, make(raw))
    try:
        yield
    finally:
        setattr(module, name, raw)


def altered_token():
    """A fault where tokens are produced: after each decode step every
    sampled token is replaced by the next id, its logprob left as the
    engine recorded it for the token it drew."""
    from repro_torch.core import rollout

    def make(raw):
        def step(params, st, cfg, ec, generator, block_tables=None):
            before = st["n_cached"].clone()
            finished = raw(params, st, cfg, ec, generator, block_tables)
            idx = torch.arange(st["tokens"].shape[0])
            pos = torch.clamp(before + 1, max=st["tokens"].shape[1] - 1)
            sampled = (pos >= st["prompt_len"]) & (pos > before)
            tok = st["tokens"][idx, pos]
            st["tokens"][idx, pos] = torch.where(
                sampled, (tok + 1) % cfg.vocab_size, tok)
            return finished
        return step

    return patched(rollout, "_engine_step", make)


def unchanged_step():
    """A fault in the optimizer step: Adam returns the weights and its
    state as they were."""
    from repro_torch.core import trainer

    def make(raw):
        def update(params, grads, state, cfg, lr=None, **k):
            return params, state, k.get("gnorm")
        return update

    return patched(trainer, "adam_update", make)


def half_batch():
    """A fault in the loss: the second half of the batch's rows left out,
    the mean taken over the rest."""
    from repro_torch.core import trainer

    def make(raw):
        def loss_fn(params, batch, cfg, rl):
            batch = dict(batch)
            mask = batch["loss_mask"].clone()
            mask[mask.shape[0] // 2:] = 0
            batch["loss_mask"] = mask
            return raw(params, batch, cfg, rl)
        return loss_fn

    return patched(trainer, "loss_fn", make)
