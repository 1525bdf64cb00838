"""The GQA decoder with routed experts of the port's Granite MoE
configurations (`model_type` granitemoe): `rlbench/arch/granite.py` with
the FFN replaced by the port's capacity-routed experts. Imports nothing of
the program.

Layout: granite's, with `moe` {`router` (L, d, E) float32, `gate`, `up`
(L, E, d, F), `down` (L, E, F, d)} in place of `ffn`.

The reference's experts: a float32 router, softmax probabilities, top-k as
k sequential top-1 passes (the first of tied maxima), a capacity per
expert of ceil(k T cf / E) rounded up to a multiple of 8 (at least 8)
counted over the call's T tokens in order, tokens past capacity dropped,
outputs weighted by the (unrenormalised) router probability; the Switch
load-balance loss E * sum(frac_top1 * mean_prob) summed over layers.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from rlbench.arch import granite

PORT_FIELDS = {**granite.PORT_FIELDS, "moe_d_ff": "intermediate_size",
               "n_experts": "num_local_experts",
               "experts_per_token": "num_experts_per_tok",
               "capacity_factor": "capacity_factor"}
PORT_LAYOUT = {"arch_type": "moe"}

TINY = {**granite.TINY, "intermediate_size": 32, "num_local_experts": 8,
        "num_experts_per_tok": 2}


def leaf_specs(c: Dict) -> List[granite.Spec]:
    """(path, shape, dtype name, init scale) of every leaf, in draw order
    (`granite.leaf_specs`)."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    F_, dt, g = c["intermediate_size"], c["torch_dtype"], granite.GROUP
    E = c["num_local_experts"]
    return granite.outer_specs(c, granite.attn_specs(c) + [
        (g + ("moe", "router"), (L, d, E), "float32", 0.02),
        (g + ("moe", "gate"), (L, E, d, F_), dt, 0.02),
        (g + ("moe", "up"), (L, E, d, F_), dt, 0.02),
        (g + ("moe", "down"), (L, E, F_, d), dt, granite.out_scale(c))])


def param_count(c: Dict, active_only: bool = False) -> int:
    """`granite.param_count` with the router and the experts for the FFN;
    `active_only` counts the experts a token uses."""
    d, E = c["hidden_size"], c["num_local_experts"]
    routed = c["num_experts_per_tok"] if active_only else E
    per_layer = granite.attn_params(c) + d * E \
        + routed * 3 * d * c["intermediate_size"]
    return granite.embed_params(c) + c["num_hidden_layers"] * per_layer


class Model(granite.Model):
    FFN = "moe"

    def ffn(self, lp, x):
        B, S, d = x.shape
        out, aux = moe(lp, x.reshape(B * S, d), self.c, self.act)
        return out.reshape(B, S, d), aux


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
