"""Attention layers: GQA (the dense decoder's) and DeepSeek-V3's multi-head
latent attention (MLA), each as a full-sequence forward, a one-token
decode against the slot cache or the paged pool, and a chunked prefill.

Inference attention goes through `kernels.ops`, which runs the CUDA kernels
on the card and their plain versions on the CPU; the kernels take any shape
the model produces, so there is no shape gate as in the JAX package.
Training on packed batches (`segment_ids` given) takes the plain,
differentiable `blocked_causal_attention`, as in the JAX package, whose
flash kernel has no backward either. MLA follows the JAX package's routes:
its full-sequence forward expands the latent into per-head keys and values
and takes `blocked_causal_attention`, its decode runs the absorbed
attention in plain code (no kernel in either package), and its chunked
prefill runs the absorbed attention through `prefill_attention` as one KV
head. Cache writes update the engine's cache tensors in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# blocked (flash-style) causal attention: the plain training path
# ---------------------------------------------------------------------------

def _mask_fill(s, mask):
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def blocked_causal_attention(q, k, v, *, scale: float, segment_ids=None,
                             window: int = 0, q_block: int = 512,
                             kv_block: int = 512):
    """q: (B,S,H,Dk); k, v: (B,S,KV,Dk/Dv), GQA via H = KV * rep. Online
    softmax over key blocks in float32, the JAX package's
    `blocked_causal_attention` (`models/attention.py:68-137`), with the same
    shape rule for taking the single-block path. `segment_ids` (B,S) keeps
    packed sequences apart; `window > 0` adds j > i - window. Differentiable
    by autograd."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    rep = H // KV
    if S % q_block or S % kv_block or S <= q_block:
        return _naive_causal_attention(q, k, v, scale=scale,
                                       segment_ids=segment_ids, window=window)
    nq, nk = S // q_block, S // kv_block
    dev = q.device
    qr = q.float().reshape(B, nq, q_block, KV, rep, Dk)
    kr = k.float().reshape(B, nk, kv_block, KV, Dk)
    vr = v.reshape(B, nk, kv_block, KV, Dv)
    pos = torch.arange(S, device=dev)
    q_pos, k_pos = pos.reshape(nq, q_block), pos.reshape(nk, kv_block)
    outs = []
    for qi in range(nq):
        qp = q_pos[qi]
        m = torch.full((B, KV, rep, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, rep, q_block, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kp = k_pos[ki]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qr[:, qi], kr[:, ki]) * scale
            mask = qp[:, None] >= kp[None, :]
            if window:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            mask = mask[None, None, None]
            if segment_ids is not None:
                sq = segment_ids[:, qi * q_block:(qi + 1) * q_block]
                sk = segment_ids[:, ki * kv_block:(ki + 1) * kv_block]
                mask = mask & (sq[:, None, :, None]
                               == sk[:, None, None, :])[:, :, None]
            s = _mask_fill(s, mask)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(v.dtype).float(), vr[:, ki].float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)                   # (B,nq,KV,rep,qb,Dv)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, Dv)
    return out.to(q.dtype)


def _naive_causal_attention(q, k, v, *, scale: float, segment_ids=None,
                            window: int = 0):
    """Full (S, S) scores: the JAX package's `_naive_causal_attention`."""
    B, S, H, Dk = q.shape
    KV = k.shape[2]
    rep = H // KV
    qr = q.float().reshape(B, S, KV, rep, Dk)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qr, k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = i >= j
    if window:
        mask = mask & ((i - j) < window)
    mask = mask[None, None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, None, :, None]
                       == segment_ids[:, None, None, None, :])
    p = torch.softmax(_mask_fill(s, mask), dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


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


def gqa_forward(p, x, positions, cfg: ModelConfig, segment_ids=None,
                return_kv: bool = False):
    """Full-sequence causal GQA (sliding-window masked when the config's
    variant says so). x: (B,S,d); segment_ids: (B,S) of a packed batch, or
    None. The flash kernel takes the unsegmented case, as the JAX gate
    `_use_flash_kernel` does; packed batches take the plain blocked path.
    Returns y, or (y, (k, v)) with k, v (B,S,KV,Dh)."""
    q, k, v = _project(p, x, positions, cfg)
    window = (cfg.sliding_window
              if cfg.attention_variant == "sliding_window" else 0)
    if segment_ids is None:
        out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), scale=_scale(cfg),
                                   window=window).transpose(1, 2)
    else:
        out = blocked_causal_attention(q, k, v, scale=_scale(cfg),
                                       segment_ids=segment_ids, window=window)
    y = _out_proj(p, out)
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
               cfg: ModelConfig, ring: bool, block_tables=None,
               paged_kernel: bool = False):
    """One-token decode. x: (B,1,d); caches (B,CL,KV,Dh), or page pools
    (NP,PS,KV,Dh) when `block_tables` (B,NB) is given, updated in place;
    cache_index: (B,) positions. Paged: the token is written into its page,
    then attention runs either on the gathered per-slot view (the slot
    engine's computation on the same values) or, with `paged_kernel`, on
    the pool through the block table (`flash_decode_paged`, equal bit for
    bit). Returns y (B,1,d)."""
    B = x.shape[0]
    q, k, v = _project(p, x, positions, cfg)
    if block_tables is None:
        CL = cache_k.shape[1]
        write_cache(cache_k, k, cache_index)
        write_cache(cache_v, v, cache_index)
    else:
        CL = block_tables.shape[1] * cache_k.shape[1]
        write_cache_paged(cache_k, k, cache_index, block_tables)
        write_cache_paged(cache_v, v, cache_index, block_tables)
    if ring:
        lengths = torch.full((B,), CL, dtype=torch.int32, device=x.device)
    else:
        # clamp to CL: once a ring cache has wrapped every slot is valid
        lengths = torch.clamp(cache_index + 1, max=CL).to(torch.int32)
    if block_tables is None:
        y = kops.flash_decode(q[:, 0], cache_k, cache_v, lengths,
                              scale=_scale(cfg))
    elif paged_kernel:
        y = kops.flash_decode_paged(q[:, 0], cache_k, cache_v, block_tables,
                                    lengths, scale=_scale(cfg))
    else:
        y = kops.flash_decode(q[:, 0], paged_gather(cache_k, block_tables),
                              paged_gather(cache_v, block_tables), lengths,
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
                      write_mask, cfg: ModelConfig, block_tables=None):
    """One GQA layer over a C-token prompt chunk. x: (B,C,d). Attends the
    chunk to the cache prefix and itself, then writes the chunk's K/V at
    offset mod CL masked by write_mask (attend-then-write: on a ring the
    writes evict exactly the slots leaving the window). With
    `block_tables` the caches are page pools: the chunk attends to the
    gathered view and is written into its page (the engine keeps the chunk
    a divisor of the page size, so it lands in one block). Returns y
    (B,C,d); the caches are updated in place."""
    q, k, v = _project(p, x, positions, cfg)
    if block_tables is None:
        view_k, view_v = cache_k, cache_v
    else:
        view_k = paged_gather(cache_k, block_tables)
        view_v = paged_gather(cache_v, block_tables)
    y = kops.prefill_attention(q, k, v, view_k, view_v, offset,
                               scale=_scale(cfg))
    off_w = offset % view_k.shape[1]
    if block_tables is None:
        write_cache_chunk(cache_k, k, off_w, write_mask)
        write_cache_chunk(cache_v, v, off_w, write_mask)
    else:
        write_cache_chunk_paged(cache_k, k, off_w, write_mask, block_tables)
        write_cache_chunk_paged(cache_v, v, off_w, write_mask, block_tables)
    return _out_proj(p, y)


# ---------------------------------------------------------------------------
# paged KV cache: block-table gather and writes. Each slot maps logical
# block j (ring positions [j*PS, (j+1)*PS)) to a page of the pool. The
# default read path gathers the per-slot contiguous view and runs the slot
# engine's attention on it, so the paged engine equals the slot engine bit
# for bit (the valid region of the view is the slot cache; trash-page
# contents only appear at positions every mask excludes). Writes go into
# the pool in place; the engine's copy-on-write discipline guarantees that
# a written page has one owner, except the trash page, which no unmasked
# read ever sees.
# ---------------------------------------------------------------------------

def paged_gather(pool, block_tables):
    """pool: (NP,PS,...); block_tables: (B,NB). Returns the per-slot view
    (B, NB*PS, ...): logical ring position p of row b at view[b, p]."""
    return pool[block_tables.long()].flatten(1, 2)


def write_cache_paged(pool, new, index, block_tables) -> None:
    """Paged twin of `write_cache`: write `new` (B,1,...) at ring position
    index mod CL of each row, in place. Inactive rows' block-table entries
    are the trash page, which absorbs their stale writes."""
    PS, NB = pool.shape[1], block_tables.shape[1]
    pos = torch.remainder(index, NB * PS).expand(new.shape[0])
    pages = block_tables.long().gather(1, (pos // PS)[:, None])[:, 0]
    pool[pages, pos % PS] = new[:, 0].to(pool.dtype)


def write_cache_chunk_paged(pool, new, offset: int, write_mask,
                            block_tables) -> None:
    """Paged twin of `write_cache_chunk`, in place: the chunk [offset,
    offset+C) lies in one logical block (C divides the page size). Masked
    rows write back what they read, so live rows' pages keep their bytes
    and rows on the trash page all write the same ones."""
    C, PS = new.shape[1], pool.shape[1]
    blk, off = divmod(int(offset), PS)
    pages = block_tables[:, blk].long()
    merged = new.to(pool.dtype)
    if write_mask is not None:
        cur = pool[pages, off:off + C]
        shape = tuple(write_mask.shape) + (1,) * (merged.dim()
                                                  - write_mask.dim())
        merged = torch.where(write_mask.reshape(shape), merged, cur)
    pool[pages, off:off + C] = merged


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): the naive expansion for the full-sequence forward, the
# absorbed form against the compressed cache for decode and prefill. The
# cache holds the normed latent c_kv (r) and the one rope key k_rope shared
# by every head; absorbing W_uk into the query scores it in latent space:
# q_nope . (W_uk c_kv) = (q_nope W_uk^T) . c_kv.
# ---------------------------------------------------------------------------

def _mla_q(p, x, positions, cfg: ModelConfig):
    """q_nope (B,S,H,nope) and the rotated q_rope (B,S,H,rope)."""
    B, S, _ = x.shape
    q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    wq_b = p["wq_b"]
    q = (q @ wq_b.reshape(wq_b.shape[0], -1)).view(B, S, wq_b.shape[1],
                                                    wq_b.shape[2])
    nope = cfg.qk_nope_dim
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_kv(p, x, positions, cfg: ModelConfig):
    """The normed latent c_kv (B,S,r) and the rotated k_rope (B,S,rope)."""
    kv = x @ p["wkv_a"]
    r = cfg.kv_lora_rank
    return (rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps),
            apply_rope(kv[..., r:], positions, cfg.rope_theta))


def _latent_heads(c_kv, w):
    """c_kv (B,S,r) through a (r,H,k) up-projection: (B,S,H,k)."""
    B, S, r = c_kv.shape
    return (c_kv @ w.reshape(r, -1)).view(B, S, w.shape[1], w.shape[2])


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_forward(p, x, positions, cfg: ModelConfig, segment_ids=None,
                return_kv: bool = False):
    """Full-sequence causal MLA, the JAX package's `mla_forward`
    (`models/attention.py:382-411`): the latent expanded into per-head
    keys [k_nope; k_rope] and values, through the plain
    `blocked_causal_attention` (differentiable, packed batches too).
    Returns y, or (y, (c_kv (B,S,r), k_rope (B,S,rope)))."""
    B, S, _ = x.shape
    H, rope = cfg.n_heads, cfg.qk_rope_dim
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_kv(p, x, positions, cfg)
    k_nope = _latent_heads(c_kv, p["wk_b"])
    v = _latent_heads(c_kv, p["wv_b"])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, rope)],
                       dim=-1)
    out = blocked_causal_attention(q_full, k_full, v, scale=_mla_scale(cfg),
                                   segment_ids=segment_ids)
    y = _out_proj(p, out)
    if return_kv:
        return y, (c_kv, k_rope)
    return y


def mla_decode(p, x, positions, cache_ckv, cache_krope, cache_index,
               cfg: ModelConfig, ring: bool, block_tables=None):
    """Absorbed one-token MLA decode, the JAX package's `mla_decode`
    (`models/attention.py:414-463`), in plain PyTorch: the JAX package
    launches no kernel here either. x: (B,1,d); caches (B,CL,r) and
    (B,CL,rope), or page pools (NP,PS,r) and (NP,PS,rope) with
    `block_tables` (B,NB): the token's latent is written into its page and
    the gathered view attended, the slot cache's computation on the same
    values. Scores and the latent output in float32. Returns y (B,1,d);
    the caches are updated in place."""
    B = x.shape[0]
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_kv(p, x, positions, cfg)
    if block_tables is None:
        CL = cache_ckv.shape[1]
        write_cache(cache_ckv, c_kv, cache_index)
        write_cache(cache_krope, k_rope, cache_index)
        view_ckv, view_krope = cache_ckv, cache_krope
    else:
        CL = block_tables.shape[1] * cache_ckv.shape[1]
        write_cache_paged(cache_ckv, c_kv, cache_index, block_tables)
        write_cache_paged(cache_krope, k_rope, cache_index, block_tables)
        view_ckv = paged_gather(cache_ckv, block_tables)
        view_krope = paged_gather(cache_krope, block_tables)
    q_latent = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["wk_b"])
    s = (torch.bmm(q_latent.float(), view_ckv.float().transpose(1, 2))
         + torch.bmm(q_rope[:, 0].float(), view_krope.float().transpose(1, 2)))
    s = s * _mla_scale(cfg)                                      # (B,H,CL)
    if not ring:
        idx = (cache_index + 1).reshape(-1, 1, 1)
        s = _mask_fill(s, torch.arange(CL, device=x.device)[None, None] < idx)
    pw = torch.softmax(s, dim=-1)
    o_latent = torch.bmm(pw.to(view_ckv.dtype).float(),
                         view_ckv.float()).to(x.dtype)           # (B,H,r)
    o = torch.einsum("bhr,rhk->bhk", o_latent, p["wv_b"])
    return _out_proj(p, o)[:, None]


def mla_prefill_chunk(p, x, positions, cache_ckv, cache_krope, offset: int,
                      write_mask, cfg: ModelConfig, block_tables=None):
    """One absorbed-MLA layer over a C-token prompt chunk, the JAX
    package's `mla_prefill_chunk` (`models/attention.py:595-645`): the
    latent is one KV head whose key is [c_kv; k_rope] (Dk = r + rope) and
    whose value is c_kv (Dv = r), so `prefill_attention` scores
    q_latent . c_kv + q_rope . k_rope against the cache prefix and the
    chunk. Attend, then write the chunk's latent at offset mod CL masked by
    write_mask; with `block_tables` against the gathered view and into the
    chunk's page. Returns y (B,C,d); the caches are updated in place."""
    if block_tables is None:
        view_ckv, view_krope = cache_ckv, cache_krope
    else:
        view_ckv = paged_gather(cache_ckv, block_tables)
        view_krope = paged_gather(cache_krope, block_tables)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_kv(p, x, positions, cfg)
    q_latent = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"])
    q_cat = torch.cat([q_latent, q_rope], dim=-1)           # (B,C,H,r+rope)
    kh_cat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None]
    kc_cat = torch.cat([view_ckv, view_krope], dim=-1)[:, :, None]
    o_latent = kops.prefill_attention(q_cat, kh_cat, c_kv[:, :, None], kc_cat,
                                      view_ckv[:, :, None], offset,
                                      scale=_mla_scale(cfg))   # (B,C,H,r)
    off_w = offset % view_ckv.shape[1]
    if block_tables is None:
        write_cache_chunk(cache_ckv, c_kv, off_w, write_mask)
        write_cache_chunk(cache_krope, k_rope, off_w, write_mask)
    else:
        write_cache_chunk_paged(cache_ckv, c_kv, off_w, write_mask,
                                block_tables)
        write_cache_chunk_paged(cache_krope, k_rope, off_w, write_mask,
                                block_tables)
    o = torch.einsum("bqhr,rhk->bqhk", o_latent.to(x.dtype), p["wv_b"])
    return _out_proj(p, o)
