"""The program under test, as the drivers build it: the port's model
configuration for a configuration file, held to the file's sizes.

Only the drivers and this module import the port (`repro_torch`); the
reference, the arithmetic and the readers do not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from rlbench import arch

# fields the harness sets from the file's options, not sizes
HARNESS_FIELDS = ("name", "source", "dtype", "fused_loss", "remat")


def config(c: Dict, device: str = "cuda"):
    """The port's config of file `c` as run (`harness.load_config`;
    `port_arch`), with the training options the file states. Raises if a
    field the architecture maps from a file key (`PORT_FIELDS`; a null in
    the file stands for the field's default) differs from the file, or if
    any other field is off its default where the architecture's layout
    (`PORT_LAYOUT`) does not say so: a part the benchmark lacks. On the
    CPU (tests) the file may ask for float32."""
    from repro_torch import get_config
    cfg = dataclasses.replace(get_config(c["port_arch"]),
                              fused_loss=bool(c["fused_loss"]),
                              remat=bool(c["remat"]))
    if c["torch_dtype"] == "float32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    a = arch.of(c)
    bad = {}
    for f in dataclasses.fields(cfg):
        got = getattr(cfg, f.name)
        if f.name in HARNESS_FIELDS:
            continue
        if f.name in a.PORT_FIELDS:
            key = a.PORT_FIELDS[f.name]
            want = f.default if c[key] is None else c[key]
            if got != want:
                bad[key] = (c[key], got)
        elif f.name in a.PORT_LAYOUT:
            if got != a.PORT_LAYOUT[f.name]:
                bad[f.name] = (a.PORT_LAYOUT[f.name], got)
        elif f.default is dataclasses.MISSING or got != f.default:
            bad[f.name] = ("a part the benchmark lacks", got)
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
