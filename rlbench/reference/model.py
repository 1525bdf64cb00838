"""The plain float32 equations that the benchmark's reference models share:
RMSNorm, split-half RoPE and causal grouped-query attention, in plain
PyTorch with no kernel, no page table and no packing. Each architecture's
`Model` (`rlbench/arch/<model_type>.py`) is built from them. Imports
nothing of the program.
"""
from __future__ import annotations

import math

import torch


def exact_float32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """Split-half rotary embedding. x: (B, S, heads, D); positions (B, S)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions.to(torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, offset: int):
    """Causal GQA. q (B, S, H, D) at positions offset..offset+S-1; k, v
    (B, T, KV, D) at positions 0..T-1 (T = offset + S). Query head h reads
    key head h // (H / KV)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kk = k.repeat_interleave(rep, dim=2)
    vv = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, kk) / math.sqrt(D)
    qi = torch.arange(S, device=q.device)[:, None] + offset
    kj = torch.arange(T, device=q.device)[None, :]
    s = s.masked_fill(kj > qi, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vv)
