"""Core layers: seeded parameter initialisation, RMSNorm, RoPE, SwiGLU.

Each function keeps the JAX package's rounding: normalisation and the
RoPE rotation run in float32 and cast back to the input dtype; SwiGLU
applies silu in float32, then casts before the gating product.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def init_leaf(shape, dtype: torch.dtype, scale: float,
              generator: torch.Generator, device) -> torch.Tensor:
    """One parameter leaf with the scales of the JAX `ParamDef.init`:
    stddev `scale` normal (drawn in float32, then cast), 0.0 -> zeros,
    -1.0 -> ones. The numbers differ from `jax.random`'s for the same seed;
    tests that compare the two packages convert one tree into the other."""
    if scale == 0.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    if scale == -1.0:
        return torch.ones(shape, dtype=dtype, device=device)
    v = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    # scaled in place: a float32 temporary of a full-width expert stack
    # (deepseek-v3's is 15 GB) is not made twice
    return v.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope_frequencies(d: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))


@functools.lru_cache(maxsize=None)
def _device_frequencies(d: int, theta: float, device: torch.device):
    # copied to the device once: a host-to-device copy on every call would
    # wait for the stream and put a sync into every decode step
    return torch.from_numpy(rope_frequencies(d, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Split-half RoPE. x: (..., seq, heads, d_head) or (..., seq, d);
    positions: (..., seq)."""
    d = x.shape[-1]
    freqs = _device_frequencies(d, float(theta), x.device)
    angles = positions.float()[..., None] * freqs  # (..., seq, d/2)
    if x.dim() == angles.dim() + 1:  # heads dimension present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def pad_before(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """x with n zeros in front along `dim`: a constant left pad written as
    a concatenation, which DTensor shards on any mesh (its pad rule fails
    on a mesh of two or more axes in torch 2.11)."""
    if n <= 0:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] = n
    zeros = torch.zeros_like(x.narrow(dim, 0, 1)).expand(*shape)
    return torch.cat([zeros, x], dim=dim)
