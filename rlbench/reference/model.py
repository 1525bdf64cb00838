"""The plain float32 reference of the benchmark's models: the port's
equations written again in plain PyTorch, with no kernel, no page table
and no packing. It imports nothing of the program.

The equations (and where they depart from the published Granite models,
which the configuration files list too):
- token embedding rows, no embedding multiplier;
- per layer: h += attn(rms_norm(h) * norm1); h += ffn(rms_norm(h) * norm2),
  no residual multiplier; RMSNorm eps as run (`as_run`);
- attention: q, k, v projections, split-half RoPE (theta from the file),
  causal grouped-query attention with scale 1/sqrt(head_dim) (not the
  published attention multiplier), output projection;
- dense FFN: down(silu(gate x) * up x);
- MoE: a float32 router, softmax probabilities, top-k as k sequential
  top-1 passes (the first of tied maxima), a capacity per expert of
  ceil(k T cf / E) rounded up to a multiple of 8 (at least 8) counted over
  the call's T tokens in order, tokens past capacity dropped, outputs
  weighted by the (unrenormalised) router probability; the Switch
  load-balance loss E * sum(frac_top1 * mean_prob) summed over layers;
- final RMSNorm, an untied head (no logits scaling), and a float32 value
  head on the normed hidden state.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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


class Model:
    """The reference forward of configuration `c` on float32 weights `p`
    (the port's tree layout, `rlbench.weights`). `act` rounds the input of
    every weight product and the attention's queries, keys and values (the
    control's float8 operands); identity by default."""

    def __init__(self, c: Dict, p: Dict, act=None):
        self.c, self.p = c, p
        self.act = act or (lambda x: x)
        self.L = c["num_hidden_layers"]
        self.eps = float(c["rms_norm_eps"])
        self.theta = float(c["rope_theta"])
        self.E = c.get("num_local_experts", 0)

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        g = self.p["groups"][0]
        out = {"norm1": g["norm1"][l], "norm2": g["norm2"][l]}
        out.update({k: v[l] for k, v in g["attn"].items()})
        ff = g["moe"] if self.E else g["ffn"]
        out.update({"f_" + k: v[l] for k, v in ff.items()})
        return out

    # ---- blocks ----------------------------------------------------------
    def qkv(self, lp, x, positions):
        B, S, d = x.shape
        xa = self.act(x)

        def proj(w):
            return (xa @ w.reshape(d, -1)).reshape(B, S, w.shape[1],
                                                   w.shape[2])

        q, k, v = proj(lp["wq"]), proj(lp["wk"]), proj(lp["wv"])
        return rope(q, positions, self.theta), rope(k, positions,
                                                     self.theta), v

    def out_proj(self, lp, y):
        B, S = y.shape[:2]
        return self.act(y.reshape(B, S, -1)) @ lp["wo"].reshape(
            -1, lp["wo"].shape[-1])

    def ffn(self, lp, x):
        """Returns (out, aux loss or None)."""
        a = self.act
        if not self.E:
            x = a(x)
            return a(F.silu(x @ lp["f_gate"]) * (x @ lp["f_up"])) \
                @ lp["f_down"], None
        B, S, d = x.shape
        out, aux = moe(lp, x.reshape(B * S, d), self.c, a)
        return out.reshape(B, S, d), aux

    def block(self, l: int, h, positions, cache=None, offset: int = 0):
        """One layer on h (B, S, d) at positions offset.. with `cache` (a
        dict that holds this layer's earlier keys and values and takes the
        new ones), or on the whole sequence. Returns (h, aux or None)."""
        lp = self.layer(l)
        x = rms_norm(h, lp["norm1"], self.eps)
        q, k, v = (self.act(y) for y in self.qkv(lp, x, positions))
        if cache is not None:
            if l in cache:
                k = torch.cat([cache[l][0], k], dim=1)
                v = torch.cat([cache[l][1], v], dim=1)
            cache[l] = (k, v)
        h = h + self.out_proj(lp, attention(q, k, v, offset))
        f, aux = self.ffn(lp, rms_norm(h, lp["norm2"], self.eps))
        return h + f, aux

    # ---- whole passes ----------------------------------------------------
    def hidden(self, tokens, positions=None, cache=None, offset: int = 0,
               remat: bool = False):
        """Final normed hidden states (B, S, d) and the summed aux loss."""
        B, S = tokens.shape
        if positions is None:
            positions = (torch.arange(S, device=tokens.device)
                         + offset)[None].expand(B, S)
        h = self.p["embed"][tokens]
        aux = torch.zeros((), device=tokens.device)
        for l in range(self.L):
            if remat:
                h, a = checkpoint(self.block, l, h, positions,
                                  use_reentrant=False)
            else:
                h, a = self.block(l, h, positions, cache, offset)
            if a is not None:
                aux = aux + a
        return rms_norm(h, self.p["final_norm"], self.eps), aux

    def token_logprobs(self, hn, targets, rows: int = 1):
        """log p(targets[b, t] | hidden hn[b, t]) for every position, the
        head applied `rows` batch rows at a time."""
        out = []
        for i in range(0, hn.shape[0], rows):
            logits = self.act(hn[i:i + rows]) @ self.p["lm_head"]
            lp = torch.log_softmax(logits, dim=-1)
            out.append(lp.gather(-1, targets[i:i + rows, :, None])[..., 0])
        return torch.cat(out)

    def values(self, hn):
        return (hn @ self.p["value_head"])[..., 0]


def capacity(n_tokens: int, c: Dict) -> int:
    cap = int(math.ceil(c["num_experts_per_tok"] * n_tokens
                        * c["capacity_factor"]
                        / c["num_local_experts"]))
    return max(8, -(-cap // 8) * 8)


def moe(lp, x, c: Dict, act=lambda v: v) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The routed experts on the call's T tokens x (T, d), in token order
    (`act` rounds each expert product's input). Returns (out (T, d), aux
    loss)."""
    T, d = x.shape
    E, k = c["num_local_experts"], c["num_experts_per_tok"]
    C = capacity(T, c)
    probs = torch.softmax(x @ lp["f_router"], dim=-1)
    top1 = probs.argmax(-1)
    aux = E * torch.sum(F.one_hot(top1, E).float().mean(0) * probs.mean(0))
    masked = probs
    counts = torch.zeros(E, dtype=torch.long, device=x.device)
    out = torch.zeros_like(x)
    for _ in range(k):
        e = masked.argmax(-1)
        w = masked.gather(1, e[:, None])[:, 0]
        onehot = F.one_hot(e, E)
        masked = masked * (1.0 - onehot.float())
        pos = counts[e] + torch.cumsum(onehot, 0)[torch.arange(T), e] - 1
        counts = counts + onehot.sum(0)
        keep = pos < C
        for j in range(E):
            sel = torch.nonzero((e == j) & keep)[:, 0]
            if sel.numel() == 0:
                continue
            xe = act(x[sel])
            ye = act(F.silu(xe @ lp["f_gate"][j]) * (xe @ lp["f_up"][j])) \
                @ lp["f_down"][j]
            out = out.index_add(0, sel, ye * w[sel, None])
    return out, aux
