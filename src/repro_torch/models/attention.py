"""GQA attention layers of the dense decoder: full-sequence forward,
one-token decode against the slot cache, and chunked prefill.

Attention itself always goes through `kernels.ops`, which runs the CUDA
kernels on the card and their plain versions on the CPU; the kernels take
any shape the model produces, so there is no shape gate as in the JAX
package. Cache writes update the engine's cache tensors in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm


def _project(p: Dict[str, torch.Tensor], x: torch.Tensor, positions,
             cfg: ModelConfig):
    """q (B,S,H,Dh), k and v (B,S,KV,Dh), normed and rotated. The (d,H,Dh)
    weights are used through (d, H*Dh) views."""
    B, S, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.use_qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, y: torch.Tensor) -> torch.Tensor:
    """y: (..., H, Dh) -> (..., d) through the (H*Dh, d) view of wo."""
    wo = p["wo"]
    return y.reshape(*y.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.d_head)


def gqa_forward(p, x, positions, cfg: ModelConfig, return_kv: bool = False):
    """Full-sequence causal GQA (sliding-window masked when the config's
    variant says so). x: (B,S,d). Returns y, or (y, (k, v)) with k, v
    (B,S,KV,Dh)."""
    q, k, v = _project(p, x, positions, cfg)
    window = (cfg.sliding_window
              if cfg.attention_variant == "sliding_window" else 0)
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale=_scale(cfg),
                               window=window)
    y = _out_proj(p, out.transpose(1, 2))
    if return_kv:
        return y, (k, v)
    return y


def write_cache(cache: torch.Tensor, new: torch.Tensor,
                index: torch.Tensor) -> None:
    """Write `new` (B,1,...) into the ring-buffer `cache` (B,CL,...) at
    slot index % CL of each row, in place; `index` is (B,) (or a scalar
    tensor for lockstep decode). Equal bit for bit to the JAX package's
    one-hot blend, since x*1 + y*0 == x for finite values."""
    CL = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, torch.remainder(index, CL)] = new[:, 0].to(cache.dtype)


def gqa_decode(p, x, positions, cache_k, cache_v, cache_index,
               cfg: ModelConfig, ring: bool):
    """One-token decode. x: (B,1,d); caches (B,CL,KV,Dh), updated in place;
    cache_index: (B,) positions. Returns y (B,1,d)."""
    B = x.shape[0]
    q, k, v = _project(p, x, positions, cfg)
    CL = cache_k.shape[1]
    write_cache(cache_k, k, cache_index)
    write_cache(cache_v, v, cache_index)
    if ring:
        lengths = torch.full((B,), CL, dtype=torch.int32, device=x.device)
    else:
        # clamp to CL: once a ring cache has wrapped every slot is valid
        lengths = torch.clamp(cache_index + 1, max=CL).to(torch.int32)
    y = kops.flash_decode(q[:, 0], cache_k, cache_v, lengths,
                          scale=_scale(cfg))
    return _out_proj(p, y)[:, None]


def write_cache_chunk(cache: torch.Tensor, new: torch.Tensor, offset: int,
                      write_mask: Optional[torch.Tensor] = None) -> None:
    """Write `new` (B,C,...) into `cache` (B,CL,...) at [offset, offset+C),
    in place. write_mask (B,) or (B,C) keeps the old value where False:
    rows not being admitted hold live K/V, and ring caches must not take
    garbage past a row's prompt. The caller reduces offset mod CL; the
    chunk size divides CL, so the slice never wraps."""
    C = new.shape[1]
    dst = cache[:, offset:offset + C]
    merged = new.to(cache.dtype)
    if write_mask is not None:
        shape = tuple(write_mask.shape) + (1,) * (cache.dim() - write_mask.dim())
        merged = torch.where(write_mask.reshape(shape), merged, dst)
    dst.copy_(merged)


def gqa_prefill_chunk(p, x, positions, cache_k, cache_v, offset: int,
                      write_mask, cfg: ModelConfig):
    """One GQA layer over a C-token prompt chunk. x: (B,C,d). Attends the
    chunk to the cache prefix and itself, then writes the chunk's K/V at
    offset mod CL masked by write_mask (attend-then-write: on a ring the
    writes evict exactly the slots leaving the window). Returns y
    (B,C,d); the caches are updated in place."""
    q, k, v = _project(p, x, positions, cfg)
    y = kops.prefill_attention(q, k, v, cache_k, cache_v, offset,
                               scale=_scale(cfg))
    off_w = offset % cache_k.shape[1]
    write_cache_chunk(cache_k, k, off_w, write_mask)
    write_cache_chunk(cache_v, v, off_w, write_mask)
    return _out_proj(p, y)
