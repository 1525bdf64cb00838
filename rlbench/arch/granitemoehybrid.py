"""Granite 4.0-H (`model_type` granitemoehybrid) with no experts, as the
port runs it: Mamba2 layers and NoPE GQA layers interleaved by the
published `layer_types`, a SwiGLU MLP in every layer. Its weight layout,
parameter count, plain reference, key map to the port's config and tiny
sizes (`rlbench/arch/__init__.py`). Imports nothing of the program.

The port's config holds the layer order as the string `layer_pattern`
("A" attention, "M" Mamba2), which the file gives under `as_run` beside the
published list: `port.config` compares each field `PORT_FIELDS` maps with
the file's value as JSON reads it, and the port's fields are hashable
scalars and strings, so a list-valued key cannot be mapped raw.
`check_pattern` ties the two.

Layout (the port's tree): `embed` (V, d), `final_norm` (d,), `lm_head`
(d, V), `value_head` (d, 1) float32 zeros, and one group of stacked layers
for each kind of layer, in the order `layer_types` first names them (the
Mamba2 layers first): `norm1`, `norm2` (L, d); a Mamba2 layer's `ssm`
{`in_proj` (L, d, 2 di + 2 G N + H) emitting [z, xBC, dt], `conv_w` (L,
k, di + 2 G N), `conv_b` (L, di + 2 G N), `A_log`, `D`, `dt_bias` (L, H)
float32, `gate_norm` (L, di), `out_proj` (L, di, d)} or an attention
layer's `attn` {`wq`, `wk`, `wv`, `wo`} (`granite.attn_specs`); `ffn`
{`gate`, `up` (L, d, F), `down` (L, F, d)}. F is
`shared_intermediate_size`, the MLP's width where `num_local_experts` is
0.

The reference's equations (and where they depart from the published
model, which the configuration file lists too):
- granite's embedding, pre-norm residual layers, MLP, final norm, head and
  value head, with granite's departures: no embedding, attention, residual
  or logits multiplier, an untied head, RMSNorm eps as run;
- an attention layer: granite's GQA with no rotary embedding
  (`position_embedding_type` "nope");
- a Mamba2 layer on x = rms_norm(h) * norm1: [z, xBC, dt] = x in_proj; a
  depthwise causal conv of xBC over the last k inputs, plus its bias, then
  silu, split into x (H heads of P), B and C (G groups of N); dt =
  softplus(dt + dt_bias); A = -exp(A_log); the sequential recurrence, head
  h reading group h / (H / G),
      s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T,   y_t = s_t C_t + D x_t;
  the gated RMSNorm rms_norm(y * silu(z)) * gate_norm over the d_inner
  channels; out_proj. It never calls a chunked scan.

Draws: granite's, and for a Mamba2 layer `in_proj` 0.02, `conv_w` and
`conv_b` 0.3 (about PyTorch's default draw for a depthwise conv of 4
taps, std 1 / sqrt(3 k)), `dt_bias` 0.5, `A_log`, `D` and `gate_norm`
ones (the port's own init: A = -e), `out_proj` granite's output scale.
With conv taps of 0.3 the state's term C s_t is as large as D x_t (RMS
0.41 and 0.34 at full width), so the recurrence, the conv bias and
dt_bias each move the output. (A draw of
`A_log` at std 1 puts some heads' decay at e^-16 a token; the Adam step
of the train-step test then differs from the port's at an `out_proj`
element whose gradient, 2e-8, lies below Adam's eps, where the chunked
and the sequential scan round differently.)
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from rlbench.arch import granite
from rlbench.reference.model import rms_norm

# the port's ModelConfig field -> the configuration-file key that holds it
PORT_FIELDS = {**granite.PORT_FIELDS, "d_ff": "shared_intermediate_size",
               "n_experts": "num_local_experts",
               "experts_per_token": "num_experts_per_tok",
               "position_embedding": "position_embedding_type",
               "ssm_state": "mamba_d_state", "ssm_n_groups": "mamba_n_groups",
               "ssm_chunk": "mamba_chunk_size", "ssm_head_dim": "mamba_d_head",
               "d_conv": "mamba_d_conv", "expand": "mamba_expand",
               "layer_pattern": "layer_pattern"}
# the other fields the port's config holds at other than their defaults
PORT_LAYOUT = {"arch_type": "interleaved"}

# the letter of each published layer type in the port's `layer_pattern`
LETTER = {"mamba": "M", "attention": "A"}

# the CPU rehearsal's sizes: two attention layers between Mamba2 layers
TINY = {**granite.TINY, "num_hidden_layers": 5,
        "shared_intermediate_size": 128, "mamba_d_state": 16,
        "mamba_d_head": 16, "mamba_n_heads": 8, "mamba_chunk_size": 8,
        "layer_types": ["mamba", "mamba", "attention", "mamba",
                        "attention"],
        "layer_pattern": "MMAMA"}


def pattern(c: Dict) -> str:
    """`layer_types` as the port's `layer_pattern` spells it."""
    return "".join(LETTER[t] for t in c["layer_types"])


def kinds(c: Dict) -> List[str]:
    """The layer types in the order of their groups."""
    return list(dict.fromkeys(c["layer_types"]))


def mamba_sizes(c: Dict) -> Dict[str, int]:
    di = c["mamba_expand"] * c["hidden_size"]
    H, P = c["mamba_n_heads"], c["mamba_d_head"]
    if H * P != di:
        raise ValueError(f"{c['name']}: {H} heads of {P} != d_inner {di}")
    G, N = c["mamba_n_groups"], c["mamba_d_state"]
    return {"di": di, "H": H, "P": P, "G": G, "N": N,
            "k": c["mamba_d_conv"], "ch": di + 2 * G * N}


def leaf_specs(c: Dict) -> List[granite.Spec]:
    """(path, shape, dtype name, init scale) of every leaf, in draw order.
    Scale: the std of a normal draw; 0.0 zeros; -1.0 ones."""
    d, F_, dt = c["hidden_size"], c["shared_intermediate_size"], \
        c["torch_dtype"]
    m = mamba_sizes(c)
    out_s = granite.out_scale(c)
    layers = []
    for gi, kind in enumerate(kinds(c)):
        g = ("groups", str(gi))
        L = c["layer_types"].count(kind)
        if kind == "attention":
            mixer = [((g + s[0][2:]), (L,) + s[1][1:], s[2], s[3])
                     for s in granite.attn_specs(c)[1:5]]
        else:
            di, H, ch = m["di"], m["H"], m["ch"]
            s = g + ("ssm",)
            mixer = [(s + ("in_proj",), (L, d, di + ch + H), dt, 0.02),
                     (s + ("conv_w",), (L, m["k"], ch), dt, 0.3),
                     (s + ("conv_b",), (L, ch), dt, 0.3),
                     (s + ("A_log",), (L, H), "float32", -1.0),
                     (s + ("D",), (L, H), "float32", -1.0),
                     (s + ("dt_bias",), (L, H), "float32", 0.5),
                     (s + ("gate_norm",), (L, di), dt, -1.0),
                     (s + ("out_proj",), (L, di, d), dt, out_s)]
        layers += ([(g + ("norm1",), (L, d), dt, -1.0)] + mixer
                   + [(g + ("norm2",), (L, d), dt, -1.0),
                      (g + ("ffn", "gate"), (L, d, F_), dt, 0.02),
                      (g + ("ffn", "up"), (L, d, F_), dt, 0.02),
                      (g + ("ffn", "down"), (L, F_, d), dt, out_s)])
    return granite.outer_specs(c, layers)


def param_count(c: Dict, active_only: bool = False) -> int:
    """Parameters of the embedding, the head and the layers: a frozen copy
    of the port's analytic count (the JAX package's rule for a Mamba2
    layer, which leaves out the conv bias, `dt_bias` and the gate norm;
    no value head)."""
    d, m = c["hidden_size"], mamba_sizes(c)
    gn = 2 * m["G"] * m["N"]
    mamba = (d * (2 * m["di"] + gn + m["H"]) + m["k"] * (m["di"] + gn)
             + 2 * m["H"] + m["di"] * d)
    attn = granite.attn_params(c) - 2 * d
    mlp = 2 * d + 3 * d * c["shared_intermediate_size"]
    n = granite.embed_params(c)
    for kind in c["layer_types"]:
        n += mlp + (attn if kind == "attention" else mamba)
    return n


class Model(granite.Model):
    """The reference forward (`granite.Model`) with the layers of
    `layer_types`: NoPE attention, or the Mamba2 mixer's sequential
    recurrence. `cache` holds, for a Mamba2 layer, its last k - 1 conv
    inputs and its state."""

    def __init__(self, c: Dict, p: Dict, act=None, quant=None):
        super().__init__(c, p, act, quant)
        if c["position_embedding_type"] != "nope":
            raise ValueError(f"{c['name']}: the reference has NoPE "
                             f"attention only")
        check_pattern(c)
        self.types = c["layer_types"]
        self.m = mamba_sizes(c)
        order, seen, self.where = kinds(c), {}, []
        for t in self.types:
            self.where.append((order.index(t), seen.get(t, 0)))
            seen[t] = seen.get(t, 0) + 1

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        gi, i = self.where[l]
        g, w = self.p["groups"][gi], self.weight
        out = {"norm1": w(g["norm1"][i]), "norm2": w(g["norm2"][i])}
        mixer = g["attn"] if "attn" in g else g["ssm"]
        out.update({k: w(v[i]) for k, v in mixer.items()})
        out.update({"f_" + k: w(v[i]) for k, v in g[self.FFN].items()})
        return out

    def qkv(self, lp, x, positions):
        B, S, d = x.shape
        xa = self.act(x)

        def proj(w):
            return (xa @ w.reshape(d, -1)).reshape(B, S, w.shape[1],
                                                   w.shape[2])

        return proj(lp["wq"]), proj(lp["wk"]), proj(lp["wv"])

    def block(self, l: int, h, positions, cache=None, offset: int = 0):
        if self.types[l] == "attention":
            return super().block(l, h, positions, cache, offset)
        lp = self.layer(l)
        x = rms_norm(h, lp["norm1"], self.eps)
        h = h + self.mamba(lp, x, cache, l)
        f, aux = self.ffn(lp, rms_norm(h, lp["norm2"], self.eps))
        return h + f, aux

    def mamba(self, lp, x, cache=None, l: int = -1):
        """The Mamba2 mixer on x (B, S, d), resuming from `cache[l]` where
        it holds this layer's state, and leaving its state there."""
        m, a = self.m, self.act
        B, S, _ = x.shape
        di, H, P, G, N, k = (m[n] for n in ("di", "H", "P", "G", "N", "k"))
        z, xbc, dt = torch.split(a(x) @ lp["in_proj"],
                                 [di, m["ch"], H], dim=-1)
        if cache is not None and l in cache:
            left, s = cache[l]
        else:
            left = x.new_zeros(B, k - 1, m["ch"])
            s = x.new_zeros(B, H, P, N)
        seq = torch.cat([left, a(xbc)], dim=1)
        conv = sum(seq[:, j:j + S] * lp["conv_w"][j] for j in range(k))
        xs, Bm, Cm = torch.split(F.silu(conv + lp["conv_b"]),
                                 [di, G * N, G * N], dim=-1)
        xs = a(xs).reshape(B, S, H, P)
        Bh = a(Bm).reshape(B, S, G, N).repeat_interleave(H // G, dim=2)
        Ch = a(Cm).reshape(B, S, G, N).repeat_interleave(H // G, dim=2)
        dt = F.softplus(dt + lp["dt_bias"])                  # (B, S, H)
        decay = torch.exp(dt * -torch.exp(lp["A_log"]))      # (B, S, H)
        ys = []
        for t in range(S):
            s = (decay[:, t, :, None, None] * s
                 + (dt[:, t, :, None] * xs[:, t])[..., None]
                 * Bh[:, t, :, None, :])
            ys.append(torch.einsum("bhpn,bhn->bhp", s, Ch[:, t]))
        y = torch.stack(ys, dim=1) + lp["D"][:, None] * xs
        y = y.reshape(B, S, di) * F.silu(z)
        y = rms_norm(y, lp["gate_norm"], self.eps)
        if cache is not None:
            cache[l] = (seq[:, S:], s)
        return a(y) @ lp["out_proj"]


def check_pattern(c: Dict) -> None:
    """Raise unless the port's `layer_pattern` spells `layer_types`."""
    if c["layer_pattern"] != pattern(c) or \
            len(c["layer_types"]) != c["num_hidden_layers"]:
        raise ValueError(f"{c['name']}: layer_pattern "
                         f"{c['layer_pattern']!r} is not layer_types")
