"""The program under test, as the drivers build it: the port's model
configuration for a configuration file, held to the file's sizes.

Only the drivers and this module import the port (`repro_torch`); the
reference, the arithmetic and the readers do not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

# configuration-file key -> the port's ModelConfig field
_WIDTHS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
           "num_attention_heads": "n_heads",
           "num_key_value_heads": "n_kv_heads", "head_dim": "d_head",
           "vocab_size": "vocab_size", "rope_theta": "rope_theta",
           "rms_norm_eps": "norm_eps",
           "tie_word_embeddings": "tie_embeddings"}
_MOE = {"num_local_experts": "n_experts",
        "num_experts_per_tok": "experts_per_token",
        "intermediate_size": "moe_d_ff",
        "capacity_factor": "capacity_factor"}


def config(c: Dict, device: str = "cuda"):
    """The port's config of file `c` as run (`harness.load_config`;
    `port_arch`), with the training options the file states; raises if any
    size differs from the file's. On the CPU (tests) the file may ask for
    float32."""
    from repro_torch import get_config
    cfg = dataclasses.replace(get_config(c["port_arch"]),
                              fused_loss=bool(c["fused_loss"]),
                              remat=bool(c["remat"]))
    if c["torch_dtype"] == "float32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    want = dict(_WIDTHS)
    want.update(_MOE if c.get("num_local_experts") else
                {"intermediate_size": "d_ff"})
    bad = {k: (c[k], getattr(cfg, f)) for k, f in want.items()
           if c[k] != getattr(cfg, f)}
    if cfg.use_qk_norm or cfg.n_shared_experts or cfg.n_dense_layers \
            or not cfg.use_value_head or cfg.arch_type not in ("dense", "moe"):
        bad["layout"] = "the port's config has parts the benchmark lacks"
    if bad:
        raise SystemExit(f"{c['name']}: the port's config differs from the "
                         f"file: {bad}")
    return cfg


def load_kernels(names) -> None:
    """Build (first run in a checkout) and load the port's kernel libraries
    the cell uses, as set-up: the port would load them at first use."""
    from repro_torch.kernels import build
    build.build(names)            # the missing ones, in parallel
    for name in names:
        build.load(name)
