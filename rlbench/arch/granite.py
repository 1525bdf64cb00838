"""The dense GQA decoder of the port's Granite configurations (`model_type`
granite): its weight layout, parameter count, plain reference, key map to
the port's config and tiny sizes (`rlbench/arch/__init__.py`). Imports
nothing of the program.

Layout (the port's tree): `embed` (V, d), `final_norm` (d,), `lm_head`
(d, V), `value_head` (d, 1) float32 zeros, and one group of stacked
layers: `norm1`, `norm2` (L, d); `attn` {`wq` (L, d, H, Dh), `wk`, `wv`
(L, d, KV, Dh), `wo` (L, H, Dh, d)}; `ffn` {`gate`, `up` (L, d, F),
`down` (L, F, d)}.

The reference's equations (and where they depart from the published
Granite models, which the configuration files list too):
- token embedding rows, no embedding multiplier;
- per layer: h += attn(rms_norm(h) * norm1); h += ffn(rms_norm(h) * norm2),
  no residual multiplier; RMSNorm eps as run (`as_run`);
- attention: q, k, v projections, split-half RoPE (theta from the file),
  causal grouped-query attention with scale 1/sqrt(head_dim) (not the
  published attention multiplier), output projection;
- FFN: down(silu(gate x) * up x);
- final RMSNorm, an untied head (no logits scaling), and a float32 value
  head on the normed hidden state.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rlbench.reference.model import attention, rms_norm, rope

# the port's ModelConfig field -> the configuration-file key that holds it
PORT_FIELDS = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
               "n_heads": "num_attention_heads",
               "n_kv_heads": "num_key_value_heads", "d_head": "head_dim",
               "vocab_size": "vocab_size", "rope_theta": "rope_theta",
               "norm_eps": "rms_norm_eps",
               "tie_embeddings": "tie_word_embeddings",
               "d_ff": "intermediate_size"}
# the other fields the port's config holds at other than their defaults
PORT_LAYOUT = {"arch_type": "dense"}

# the CPU rehearsal's sizes
TINY = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 96,
        "intermediate_size": 128}

Spec = Tuple[Tuple[str, ...], tuple, str, float]
GROUP = ("groups", "0")


def outer_specs(c: Dict, layers: List[Spec]) -> List[Spec]:
    """The embedding and final norm, the stacked `layers`, then the head and
    the value head, in draw order."""
    d, V, dt = c["hidden_size"], c["vocab_size"], c["torch_dtype"]
    return ([(("embed",), (V, d), dt, 0.02),
             (("final_norm",), (d,), dt, -1.0)] + layers
            + [(("lm_head",), (d, V), dt, 0.02),
               (("value_head",), (d, 1), "float32", 0.0)])


def attn_specs(c: Dict) -> List[Spec]:
    """`norm1` and the GQA projections of the stacked layers."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    Dh, dt = c["head_dim"], c["torch_dtype"]
    g = GROUP
    return [(g + ("norm1",), (L, d), dt, -1.0),
            (g + ("attn", "wq"), (L, d, H, Dh), dt, 0.02),
            (g + ("attn", "wk"), (L, d, KV, Dh), dt, 0.02),
            (g + ("attn", "wv"), (L, d, KV, Dh), dt, 0.02),
            (g + ("attn", "wo"), (L, H, Dh, d), dt, out_scale(c)),
            (g + ("norm2",), (L, d), dt, -1.0)]


def out_scale(c: Dict) -> float:
    """The std of the output projections' draws."""
    return 0.02 / math.sqrt(2 * c["num_hidden_layers"])


def leaf_specs(c: Dict) -> List[Spec]:
    """(path, shape, dtype name, init scale) of every leaf, in draw order.
    Scale: the std of a normal draw; 0.0 zeros; -1.0 ones."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    F_, dt, g = c["intermediate_size"], c["torch_dtype"], GROUP
    return outer_specs(c, attn_specs(c) + [
        (g + ("ffn", "gate"), (L, d, F_), dt, 0.02),
        (g + ("ffn", "up"), (L, d, F_), dt, 0.02),
        (g + ("ffn", "down"), (L, F_, d), dt, out_scale(c))])


def attn_params(c: Dict) -> int:
    """One layer's norms and GQA projections."""
    d, Dh = c["hidden_size"], c["head_dim"]
    return (2 * d + 2 * d * c["num_attention_heads"] * Dh
            + 2 * d * c["num_key_value_heads"] * Dh)


def embed_params(c: Dict) -> int:
    return c["vocab_size"] * c["hidden_size"] * (
        1 if c["tie_word_embeddings"] else 2)


def param_count(c: Dict, active_only: bool = False) -> int:
    """Parameters of the embedding, the head and the layers (a frozen copy
    of the port's analytic count; no value head)."""
    per_layer = attn_params(c) + 3 * c["hidden_size"] * c["intermediate_size"]
    return embed_params(c) + c["num_hidden_layers"] * per_layer


class Model:
    """The reference forward of configuration `c` on weights `p` (the
    port's tree layout, `leaf_specs`), in float32: each weight is read as
    float32 where it is used (`weight`), a layer's slice of a stacked leaf
    at a time, so that a tree kept in the served type costs no float32 copy
    of the whole. `quant` rounds each weight so read, and `act` the input
    of every weight product and the attention's queries, keys and values
    (the control's float8 weights and operands); identity by default."""

    FFN = "ffn"   # the stacked group that holds the feed-forward leaves

    def __init__(self, c: Dict, p: Dict, act=None, quant=None):
        self.c, self.p = c, p
        self.act = act or (lambda x: x)
        self.quant = quant or (lambda x: x)
        self.L = c["num_hidden_layers"]
        self.eps = float(c["rms_norm_eps"])
        self.theta = float(c["rope_theta"])

    def weight(self, x: torch.Tensor) -> torch.Tensor:
        """A weight (a whole leaf, or a layer's slice of a stacked one) as
        the forward reads it: in float32, through `quant`."""
        return self.quant(x.float())

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        g, w = self.p["groups"][0], self.weight
        out = {"norm1": w(g["norm1"][l]), "norm2": w(g["norm2"][l])}
        out.update({k: w(v[l]) for k, v in g["attn"].items()})
        out.update({"f_" + k: w(v[l]) for k, v in g[self.FFN].items()})
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
        x = a(x)
        return a(F.silu(x @ lp["f_gate"]) * (x @ lp["f_up"])) \
            @ lp["f_down"], None

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
        h = self.weight(self.p["embed"])[tokens]
        aux = torch.zeros((), device=tokens.device)
        for l in range(self.L):
            if remat:
                h, a = checkpoint(self.block, l, h, positions,
                                  use_reentrant=False)
            else:
                h, a = self.block(l, h, positions, cache, offset)
            if a is not None:
                aux = aux + a
        return rms_norm(h, self.weight(self.p["final_norm"]), self.eps), aux

    def token_logprobs(self, hn, targets, rows: int = 1):
        """log p(targets[b, t] | hidden hn[b, t]) for every position, the
        head applied `rows` batch rows at a time."""
        out, head = [], self.weight(self.p["lm_head"])
        for i in range(0, hn.shape[0], rows):
            logits = self.act(hn[i:i + rows]) @ head
            lp = torch.log_softmax(logits, dim=-1)
            out.append(lp.gather(-1, targets[i:i + rows, :, None])[..., 0])
        return torch.cat(out)

    def values(self, hn):
        return (hn @ self.weight(self.p["value_head"]))[..., 0]
