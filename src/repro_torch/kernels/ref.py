"""Plain PyTorch versions of the kernels. The attention ones keep the kernels'
calling conventions and rounding: q, k and v are cast to float32, scores,
softmax and the PV product stay in float32, and only the output is cast
back to q's dtype (the Pallas kernels do the same, `flash_attention.py:41-43`,
`decode_attention.py:55-57`, `prefill_attention.py:73-75`). Masked scores
are -1e30, as in the JAX package. The fused lm-head loss has two: the
full-logits oracle `fused_logprob_ref` and the vocab-blocked twin
`fused_logprob_blocked`, which sums the logits in float32 as the kernels do.
The SSD scan's is `ssd_scan_ref`, the model's chunked SSD with the kernel's
calling convention.

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


def flash_decode_paged_ref(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: float):
    """q: (B,H,Dk); pools: (NP,PS,KV,D); block_tables: (B,NB) page ids;
    lengths: (B,) valid logical positions per row. Gathers each row's pages
    into the contiguous (B, NB*PS, KV, D) view (logical position p of row b
    is page block_tables[b, p // PS] at offset p % PS), then runs
    `flash_decode_ref` on it. Returns (B,H,Dv) in q's dtype."""
    bt = block_tables.long()
    k = k_pool[bt].flatten(1, 2)
    v = v_pool[bt].flatten(1, 2)
    return flash_decode_ref(q, k, v, lengths, scale=scale)


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


# ---------------------------------------------------------------------------
# fused linear-cross-entropy (the lm-head loss)
# ---------------------------------------------------------------------------

def _head_block(head, lo: int, hi: int, transpose_head: bool):
    """Columns [lo, hi) of the head as a (D, hi-lo) float32 matrix."""
    wb = head[lo:hi].T if transpose_head else head[:, lo:hi]
    return wb.float()


def _vocab(head, transpose_head: bool) -> int:
    return head.shape[0] if transpose_head else head.shape[1]


def fused_logprob_ref(hidden, head, targets, *, transpose_head: bool = False):
    """The full-logits oracle of `fused_logprob`: hidden (N,D); head (D,V),
    or (V,D) with transpose_head; targets (N,) integer. Returns (logprob,
    lse, entropy), each (N,) float32, with the logits summed in float32.
    Differentiable by autograd."""
    w = head.T if transpose_head else head
    logits = hidden.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt_l = logits.gather(1, targets.long()[:, None])[:, 0]
    p = torch.exp(logits - lse[:, None])
    entropy = lse - (p * logits).sum(-1)
    return tgt_l - lse, lse, entropy


class _Blocked(torch.autograd.Function):
    """Vocab-blocked forward and softmax-recompute backward, the torch twin
    of the JAX package's `_blocked` / `_blocked_bwd`
    (`kernels/fused_logprob.py:405-499`). The last block is cut at V rather
    than padded and masked, which adds and drops the same terms."""

    @staticmethod
    def forward(ctx, hidden, head, targets, transpose_head, block_v,
                dw_chunks):
        N = hidden.shape[0]
        V = _vocab(head, transpose_head)
        h = hidden.float()
        tgt = targets.long()
        dev = hidden.device
        m = torch.full((N,), NEG_INF, dtype=torch.float32, device=dev)
        s = torch.zeros(N, dtype=torch.float32, device=dev)
        a = torch.zeros_like(s)
        tl = torch.zeros_like(s)
        for lo in range(0, V, block_v):
            hi = min(lo + block_v, V)
            l = h @ _head_block(head, lo, hi, transpose_head)
            m2 = torch.maximum(m, l.amax(dim=-1))
            p = torch.exp(l - m2[:, None])
            corr = torch.exp(m - m2)
            s = s * corr + p.sum(-1)
            a = a * corr + (p * l).sum(-1)
            col = torch.arange(lo, hi, device=dev)
            tl = tl + torch.where(col[None] == tgt[:, None], l,
                                  torch.zeros_like(l)).sum(-1)
            m = m2
        s = torch.clamp(s, min=1e-30)
        lse = m + torch.log(s)
        ent = lse - a / s
        ctx.save_for_backward(hidden, head, targets, lse, ent)
        ctx.cfg = (transpose_head, block_v, dw_chunks)
        return tl - lse, lse, ent

    @staticmethod
    def backward(ctx, g_lp, g_lse, g_ent):
        hidden, head, targets, lse, ent = ctx.saved_tensors
        transpose_head, block_v, dw_chunks = ctx.cfg
        dh, dw = blocked_backward(hidden, head, targets, lse, ent, g_lp,
                                  g_lse, g_ent, transpose_head=transpose_head,
                                  block_v=block_v, dw_chunks=dw_chunks,
                                  want_dh=ctx.needs_input_grad[0],
                                  want_dw=ctx.needs_input_grad[1])
        return dh, dw, None, None, None, None


def logits_grad_coef(lse, ent, g_lp, g_lse, g_ent):
    """The row coefficients of the logits gradient: (c0, g_lp, g_ent) with
    c0 = g_lse - g_lp + g_ent * (lse - H), so that
    dl = g_lp * 1[v == target] + p * (c0 - g_ent * l)
    (`fused_logprob.py:385`). Missing cotangents count as zeros."""
    g_lp, g_lse, g_ent = (torch.zeros_like(lse) if g is None else g.float()
                          for g in (g_lp, g_lse, g_ent))
    return g_lse - g_lp + g_ent * (lse - ent), g_lp, g_ent


def blocked_backward(hidden, head, targets, lse, ent, g_lp, g_lse, g_ent, *,
                     transpose_head: bool, block_v: int = 512,
                     dw_chunks: int = 1, want_dh: bool = True,
                     want_dw: bool = True):
    """(dhidden, dhead) of `fused_logprob`, vocab block by vocab block, each
    block's softmax recomputed from the saved lse. dw_chunks > 1 sums the
    head gradient of each block as per-row-chunk float32 partials, like the
    kernel's two-level reduction. Returns dh in the hidden dtype and dw in
    the head's dtype and layout; a gradient not wanted is None."""
    c0, g_lp, g_ent = logits_grad_coef(lse, ent, g_lp, g_lse, g_ent)
    N, D = hidden.shape
    V = _vocab(head, transpose_head)
    h = hidden.float()
    tgt = targets.long()
    dev = hidden.device
    rows = -(-N // max(int(dw_chunks), 1))
    dh = torch.zeros((N, D) if want_dh else (0,), dtype=torch.float32,
                     device=dev)
    dw = torch.empty((D, V) if want_dw else (0, 0), dtype=torch.float32,
                     device=dev)
    for lo in range(0, V, block_v):
        hi = min(lo + block_v, V)
        wb = _head_block(head, lo, hi, transpose_head)           # (D, bv)
        l = h @ wb
        col = torch.arange(lo, hi, device=dev)
        p = torch.exp(l - lse[:, None])
        onehot = (col[None] == tgt[:, None]).float()
        dl = g_lp[:, None] * onehot + p * (c0[:, None] - g_ent[:, None] * l)
        if want_dh:
            dh = dh + dl @ wb.T
        if want_dw:
            dw[:, lo:hi] = sum(h[r:r + rows].T @ dl[r:r + rows]
                               for r in range(0, N, rows))
    dw = dw.T if transpose_head else dw
    return (dh.to(hidden.dtype) if want_dh else None,
            dw.to(head.dtype).contiguous() if want_dw else None)


def fused_logprob_blocked(hidden, head, targets, *,
                          transpose_head: bool = False, block_v: int = 512,
                          dw_chunks: int = 1):
    """The plain version of `fused_logprob`: same online-logsumexp forward
    and softmax-recompute backward in vocab blocks, so the (N, V) logits and
    their gradient never exist. Differentiable w.r.t. hidden and head."""
    assert hidden.dim() == 2 and head.dim() == 2 and targets.dim() == 1
    return _Blocked.apply(hidden, head, targets, bool(transpose_head),
                          int(block_v), int(dw_chunks))


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 64):
    """The plain `ssd_scan`: x (b,l,h,p); dt (b,l,h) float32 (softplus'd);
    A (h,) float32, negative; B, C (b,l,g,n), head h reading group
    h // (h/g). Returns y (b,l,h,p) in x's dtype and the final state
    (b,h,n,p) float32, the layout the kernel emits (the model's chunked
    SSD keeps (b,h,p,n))."""
    # imported here: models.ssm imports kernels.ops, which imports this
    from repro_torch.models.ssm import ssd_chunked
    y, state = ssd_chunked(x, dt, A, B, C, chunk)
    return y, state.transpose(-1, -2)
