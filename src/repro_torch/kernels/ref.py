"""Plain PyTorch versions of the attention kernels, with the kernels'
calling conventions and rounding: q, k and v are cast to float32, scores,
softmax and the PV product stay in float32, and only the output is cast
back to q's dtype (the Pallas kernels do the same, `flash_attention.py:41-43`,
`decode_attention.py:55-57`, `prefill_attention.py:73-75`). Masked scores
are -1e30, as in the JAX package.

The wrappers in `kernels/ops.py` run these on CPU tensors; on the card
they are the reference the CUDA kernels are held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, scale: float, window: int = 0):
    """q: (B,H,S,Dk); k,v: (B,KV,S,Dk/Dv), GQA via h // rep. Causal;
    `window > 0` adds the sliding-window constraint i - j < window.
    Returns (B,H,S,Dv) in q's dtype."""
    B, H, S, Dk = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    rep = H // KV
    qf = q.float().reshape(B, KV, rep, S, Dk)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = i >= j
    if window:
        mask &= (i - j) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return out.reshape(B, H, S, Dv).to(q.dtype)


def flash_decode_ref(q, k_cache, v_cache, lengths, *, scale: float):
    """q: (B,H,Dk); caches: (B,CL,KV,D); lengths: (B,) valid slots per row
    (CL for a full ring). Returns (B,H,Dv) in q's dtype."""
    B, H, Dk = q.shape
    CL, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    qr = q.float().reshape(B, KV, rep, Dk)
    s = torch.einsum("bgrd,bkgd->bgrk", qr, k_cache.float()) * scale
    valid = (torch.arange(CL, device=q.device)[None]
             < lengths.reshape(-1, 1).to(q.device))          # (B,CL)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return out.reshape(B, H, v_cache.shape[-1]).to(q.dtype)


def prefill_attention_ref(q, k_chunk, v_chunk, k_cache, v_cache, offset: int,
                          *, scale: float):
    """Chunked-prefill attention. q: (B,C,H,Dk); k_chunk/v_chunk:
    (B,C,KV,D); caches (B,CL,KV,D) in their pre-chunk state; offset: the
    absolute position of the chunk's first token.

    Query i (position qp = offset+i) attends to cache slot j, which holds
    position p_j = offset-1 - ((offset-1-j) mod CL) (floor mod), when
    p_j >= 0 and qp - p_j < CL, and to the chunk's own keys causally."""
    B, C, H, Dk = q.shape
    CL, KV = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    rep = H // KV
    dev = q.device
    qr = q.float().reshape(B, C, KV, rep, Dk)
    qp = offset + torch.arange(C, device=dev)                      # (C,)
    j = torch.arange(CL, device=dev)
    p_j = (offset - 1) - torch.remainder(offset - 1 - j, CL)      # (CL,)
    valid = (p_j[None] >= 0) & (qp[:, None] - p_j[None] < CL)     # (C,CL)
    s_cache = torch.einsum("bqgrd,bkgd->bgrqk", qr, k_cache.float()) * scale
    s_cache = torch.where(valid, s_cache, torch.full_like(s_cache, NEG_INF))
    s_chunk = torch.einsum("bqgrd,bkgd->bgrqk", qr, k_chunk.float()) * scale
    causal = (torch.arange(C, device=dev)[:, None]
              >= torch.arange(C, device=dev)[None, :])
    s_chunk = torch.where(causal, s_chunk, torch.full_like(s_chunk, NEG_INF))
    p = torch.softmax(torch.cat([s_cache, s_chunk], dim=-1), dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p[..., :CL], v_cache.float())
    out = out + torch.einsum("bgrqk,bkgd->bqgrd", p[..., CL:], v_chunk.float())
    return out.reshape(B, C, H, Dv).to(q.dtype)
