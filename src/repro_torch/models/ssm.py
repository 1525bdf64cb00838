"""Mamba2 / SSD (state-space duality) block. [arXiv:2405.21060]

The counterpart of the JAX package's `repro.models.ssm`: the chunked SSD
for the full-sequence forward and chunked prefill, the depthwise causal
conv, and the O(1)-state recurrent step for decode. Rounding follows the
JAX code: the conv runs in the model dtype, silu and softplus in float32,
the scan in float32, and `y` is cast back to the model dtype before the
gate.

The full-sequence forward takes the hand-written `ssd_scan` kernel
(`kernels.ops.ssd_scan`) under the JAX package's gate (`S % ssm_chunk == 0`,
no carried state, no token mask) and one more condition: no input of the
scan requires grad. The kernel has no backward, as the Pallas kernel has
none (`jax.grad` through it raises), so the JAX package trains an SSM only
through `ssd_chunked`; the port's Trainer does the same, and the
Preprocessor's forward, under `torch.no_grad`, takes the kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import pad_before, rms_norm
from repro_torch.shardctx import (constrain, local_call, merge_last,
                                  split_last)


def ssm_shapes(cfg: ModelConfig, n_stack: int) -> Dict[str, Any]:
    """(shape, dtype, init scale, logical axes) of the SSM leaves of
    `n_stack` stacked layers, as `repro.models.ssm.ssm_defs` defines them."""
    d, dt = cfg.d_model, cfg.dtype
    di, G, N, H = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * G * N
    L = n_stack
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        # in_proj emits [z (di), xBC (di + 2GN), dt (H)]
        "in_proj": ((L, d, 2 * di + 2 * G * N + H), dt, 0.02,
                    ("layers", "p_embed", "p_inner")),
        "conv_w": ((L, cfg.d_conv, conv_ch), dt, 0.02,
                   ("layers", "p_conv", "p_inner")),
        "conv_b": ((L, conv_ch), dt, 0.0, ("layers", "p_inner")),
        "A_log": ((L, H), torch.float32, -1.0, ("layers", "p_none")),
        "D": ((L, H), torch.float32, -1.0, ("layers", "p_none")),
        "dt_bias": ((L, H), torch.float32, 0.0, ("layers", "p_none")),
        "gate_norm": ((L, di), dt, -1.0, ("layers", "p_inner")),
        "out_proj": ((L, di, d), dt, out_scale,
                     ("layers", "p_inner", "p_embed")),
    }


def _segsum(x):
    """x: (..., Q). Lower-triangular pairwise cumulative sums:
    out[..., i, j] = sum_{k=j+1..i} x[..., k] (i >= j), -inf above the
    diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=x.device)
    return out.masked_fill(i[:, None] < i[None, :], float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD. x: (b,l,h,p); dt: (b,l,h); A: (h,) (negative); B, C:
    (b,l,g,n). Returns y (b,l,h,p) in x's dtype and the final state
    (b,h,p,n) in the compute dtype. `initial_state` (b,h,p,n) seeds the inter-chunk
    recurrence (chunked prefill feeds the previous chunk's state here).

    The JAX code's five-operand einsums are written as pairwise products
    over the (group, head-in-group) split of h, so no operand is repeated
    to all heads and the largest intermediate is the (b,c,h,p,n) chunk
    states; the inter-chunk scan is a Python loop over chunks. It computes
    in float32, or in float64 when given float64 (an exact yardstick)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    L = x.shape[1]
    nc, rep, Q = L // chunk, h // g, chunk
    wide = torch.promote_types(x.dtype, torch.float32)

    xd = (x * dt[..., None]).to(wide)                    # fold dt into x
    dA = dt * A[None, None, :]                           # (b,L,h)
    xc = xd.reshape(b, nc, Q, g, rep, p)
    dAc = dA.reshape(b, nc, Q, h).permute(0, 3, 1, 2)    # (b,h,nc,Q)
    Bc = B.to(wide).reshape(b, nc, Q, g, n)
    Cc = C.to(wide).reshape(b, nc, Q, g, n)

    def per_head(t):  # (b,h,nc,Q[,Q]) -> (b,nc,[Q,]g,rep,...) for products
        return t.permute(0, 2, 3, 1).reshape(b, nc, Q, g, rep, 1)

    A_cum = torch.cumsum(dAc, dim=-1)                    # (b,h,nc,Q)

    # --- intra-chunk (diagonal blocks): (C B^T * L) (dt x)
    Lmat = torch.exp(_segsum(dAc))                       # (b,h,nc,Q,Q)
    CB = torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc)      # (b,nc,g,Q,Q)
    scores = CB[:, :, :, None] * Lmat.permute(0, 2, 1, 3, 4).reshape(
        b, nc, g, rep, Q, Q)
    Y_diag = torch.einsum("bcgrqs,bcsgrp->bcqgrp", scores, xc)

    # --- chunk states: B^T (decay * dt x)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)    # (b,h,nc,Q)
    states = torch.einsum("bcqgn,bcqgrp->bcgrpn", Bc,
                          xc * per_head(decay_states))
    states = states.reshape(b, nc, h, p, n)

    # --- inter-chunk recurrence, sequential over chunks
    chunk_decay = torch.exp(A_cum[..., -1])              # (b,h,nc)
    if initial_state is None:
        carry = torch.zeros((b, h, p, n), dtype=wide, device=x.device)
    else:
        carry = initial_state.to(wide)
    prev = []
    for c in range(nc):
        prev.append(carry)                               # state *before* c
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1).reshape(b, nc, g, rep, p, n)

    # --- carried-state term: exp(A_cum) C state
    Y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc, prev_states) \
        * per_head(torch.exp(A_cum))
    y = (Y_diag + Y_off).reshape(b, L, h, p)[:, :l]
    return y.to(x.dtype), carry


def _causal_conv(xBC, w, bias, left=None):
    """Depthwise causal conv. xBC: (b,l,ch); w: (k,ch). `left` (b,k-1,ch)
    supplies the pre-conv inputs preceding this chunk (zero padding when
    absent: the start of a sequence)."""
    k = w.shape[0]
    if left is None:
        pad = pad_before(xBC, k - 1, -2)
    else:
        pad = torch.cat([left.to(xBC.dtype), xBC], dim=1)
    S = xBC.shape[1]
    # sum_i x[t-k+1+i] * w[i]
    out = sum(pad[:, i:i + S] * w[i] for i in range(k))
    return out + bias


def _differentiated(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ssm_forward(p, x, cfg: ModelConfig, return_state: bool = False,
                initial_state=None, token_mask=None):
    """Full-sequence Mamba2 block. x: (B,S,d) -> (B,S,d).

    initial_state=(conv_state (B,k-1,ch), ssd_state (B,H,P,N)) resumes the
    recurrence mid-sequence: chunked prefill runs a prompt in fixed-size
    chunks and threads the state between calls.

    token_mask (B,S) marks the chunk positions that belong to the sequence
    (a contiguous prefix per row). Masked tokens add nothing to the SSD
    state (their dt is zeroed, so the decay is 1 and the input 0), and the
    returned conv state is gathered at each row's last valid position:
    rows whose prompt ended in an earlier chunk pass through with both
    states unchanged.

    The scan takes `kernels.ops.ssd_scan` when S % ssm_chunk == 0, no state
    is carried in, no token mask is given and no input of the scan
    requires grad; otherwise `ssd_chunked` (see the module docstring)."""
    di, G, N, H = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.n_ssm_heads
    P = cfg.ssm_head_dim
    conv_left = ssd_init = None
    if initial_state is not None:
        conv_left, ssd_init = initial_state
    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    xBC_pre = xBC
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"], left=conv_left)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs, B, C = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = constrain(xs, ("batch", "seq", "mlp"))
    S = x.shape[1]
    # views of xBC: the kernel reads them through their strides
    xs = split_last(xs, H, P)
    B = split_last(B, G, N)
    C = split_last(C, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    if token_mask is not None:
        # masked tokens: dt = 0 => decay exp(0) = 1 and input dt*x = 0, a
        # structural no-op on the SSD recurrence
        dt = dt * token_mask[..., None]
    A = -torch.exp(p["A_log"])
    # the kernel raises for widths it does not hold (bfloat16: N above 256,
    # P above 256, or 128 above N 128; float32: a state and two chunk
    # tiles past a block's shared memory), which no config here reaches
    # under a mesh each rank scans its batch rows and heads; heads split
    # across ranks carry their groups along (G == 1: every rank reads the
    # one group whole)
    grp = None if G == 1 else 2
    dims = ((0, 2), (0, 2), (None, 0), (0, grp), (0, grp))
    if (S % cfg.ssm_chunk == 0 and ssd_init is None and token_mask is None
            and not _differentiated(xs, dt, A, B, C)):
        y, state = local_call(kops.ssd_scan, (xs, dt, A, B, C), dims,
                              ((0, 2), (0, 1)), chunk=cfg.ssm_chunk)
        y = y.float()
        state = state.transpose(-1, -2)  # the kernel emits (b,h,n,p)
    elif ssd_init is None:
        y, state = local_call(ssd_chunked, (xs, dt, A, B, C), dims,
                              ((0, 2), (0, 1)), chunk=cfg.ssm_chunk)
    else:
        y, state = local_call(
            lambda *a: ssd_chunked(*a[:5], cfg.ssm_chunk, initial_state=a[5]),
            (xs, dt, A, B, C, ssd_init), dims + ((0, 1),), ((0, 2), (0, 1)))
    y = y + xs.float() * p["D"][None, None, :, None]
    y = merge_last(y).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"],
                 cfg.norm_eps)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    # conv state = the last (d_conv-1) pre-conv inputs (the carried left
    # context prepended, or zero padding, so short chunks still have k-1
    # rows)
    k = cfg.d_conv
    if conv_left is not None:
        pre = torch.cat([conv_left.to(xBC_pre.dtype), xBC_pre], dim=1)
    else:
        pre = pad_before(xBC_pre, max(0, k - 1 - S), -2)
    if token_mask is None:
        return out, (pre[:, -(k - 1):], state)
    # per row: the k-1 inputs ending at the last valid position. rel = the
    # valid tokens of this chunk; indices rel + arange into [left ; chunk]
    # land on the old conv state when rel == 0, so finished rows pass
    # through unchanged. The gather needs exactly k-1 rows of left context:
    # zero padding when no state was carried (start of sequence).
    if conv_left is None:
        pre = pad_before(xBC_pre, k - 1, -2)
    rel = token_mask.sum(dim=1).long()                            # (B,)
    idx = rel[:, None] + torch.arange(k - 1, device=x.device)[None]
    conv_new = torch.gather(pre, 1,
                            idx[:, :, None].expand(-1, -1, pre.shape[-1]))
    return out, (conv_new, state)


def ssm_decode(p, x, conv_state, ssd_state, cfg: ModelConfig):
    """One-token recurrent step. x: (B,1,d); conv_state: (B,k-1,ch);
    ssd_state: (B,H,P,N) float32. Returns y (B,1,d) and the new
    (conv_state, ssd_state)."""
    di, G, N, H = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.n_ssm_heads
    P = cfg.ssm_head_dim
    zxbcdt = (x @ p["in_proj"])[:, 0]
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    # conv over [state ; new]
    window = torch.cat([conv_state, xBC[:, None]], dim=1)        # (b,k,ch)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_state = window[:, 1:]
    xBC = F.silu(conv_out.float()).to(x.dtype)
    xs, B, C = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = split_last(xs, H, P)
    rep = H // G
    Bh = split_last(B, G, N).repeat_interleave(rep, dim=1).float()  # (b,H,N)
    Ch = split_last(C, G, N).repeat_interleave(rep, dim=1).float()
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (b,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None])                                  # (b,H)
    dx = dt[..., None] * xs.float()                               # (b,H,P)
    ssd_state = ssd_state * dA[..., None, None] \
        + dx[..., :, None] * Bh[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", ssd_state, Ch)              # (b,H,P)
    y = y + xs.float() * p["D"][None, :, None]
    y = merge_last(y).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"],
                 cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None]
    return out, (conv_state, ssd_state)
