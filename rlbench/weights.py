"""Random weights from a seed, in the port's parameter layout, made by the
benchmark itself: one normal draw per stacked leaf on the device, in the
type the model is served in. The plain reference calls the same function
with the same seed to get the same numbers; it takes no weight from the
program.

Layout (the port's tree): `embed` (V, d), `final_norm` (d,), `lm_head`
(d, V), `value_head` (d, 1) float32 zeros, and one group of stacked
layers: `norm1`, `norm2` (L, d); `attn` {`wq` (L, d, H, Dh), `wk`, `wv`
(L, d, KV, Dh), `wo` (L, H, Dh, d)}; dense `ffn` {`gate`, `up` (L, d, F),
`down` (L, F, d)} or `moe` {`router` (L, d, E) float32, `gate`, `up`
(L, E, d, F), `down` (L, E, F, d)}.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_specs(c: Dict) -> List[Tuple[Tuple[str, ...], tuple, str, float]]:
    """(path, shape, dtype name, init scale) of every leaf, in draw order.
    Scale: the std of a normal draw; 0.0 zeros; -1.0 ones."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    Dh = c["head_dim"]
    V, F = c["vocab_size"], c["intermediate_size"]
    dt = c["torch_dtype"]
    out_scale = 0.02 / math.sqrt(2 * L)
    g = ("groups", "0")
    specs = [
        (("embed",), (V, d), dt, 0.02),
        (("final_norm",), (d,), dt, -1.0),
        (g + ("norm1",), (L, d), dt, -1.0),
        (g + ("attn", "wq"), (L, d, H, Dh), dt, 0.02),
        (g + ("attn", "wk"), (L, d, KV, Dh), dt, 0.02),
        (g + ("attn", "wv"), (L, d, KV, Dh), dt, 0.02),
        (g + ("attn", "wo"), (L, H, Dh, d), dt, out_scale),
        (g + ("norm2",), (L, d), dt, -1.0),
    ]
    E = c.get("num_local_experts", 0)
    if E:
        specs += [
            (g + ("moe", "router"), (L, d, E), "float32", 0.02),
            (g + ("moe", "gate"), (L, E, d, F), dt, 0.02),
            (g + ("moe", "up"), (L, E, d, F), dt, 0.02),
            (g + ("moe", "down"), (L, E, F, d), dt, out_scale),
        ]
    else:
        specs += [
            (g + ("ffn", "gate"), (L, d, F), dt, 0.02),
            (g + ("ffn", "up"), (L, d, F), dt, 0.02),
            (g + ("ffn", "down"), (L, F, d), dt, out_scale),
        ]
    specs += [(("lm_head",), (d, V), dt, 0.02),
              (("value_head",), (d, 1), "float32", 0.0)]
    return specs


def _node(tree: Dict, path: Tuple[str, ...], make: bool):
    """The dict that holds the leaf at `path` ("0" indexes the group
    list)."""
    node = tree
    for key in path[:-1]:
        if key == "0":
            if make and not node:
                node.append({})
            node = node[0]
        else:
            node = node.setdefault(key, [] if key == "groups" else {}) \
                if make else node[key]
    return node


def make_params(c: Dict, seed: int, device, dtype=None) -> Dict:
    """The weights of configuration `c` from `seed`, drawn by a generator on
    `device`. `dtype`, when given, casts every drawn leaf afterwards (the
    reference asks for float32 copies of the same numbers)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tree: Dict = {}
    for path, shape, dt, scale in leaf_specs(c):
        t_dt = DTYPES[dt]
        if scale == 0.0:
            v = torch.zeros(shape, dtype=t_dt, device=device)
        elif scale == -1.0:
            v = torch.ones(shape, dtype=t_dt, device=device)
        else:
            v = torch.randn(shape, generator=gen, dtype=t_dt, device=device)
            v.mul_(scale)
        if dtype is not None:
            v = v.to(dtype)
        _node(tree, path, True)[path[-1]] = v
    return tree


def leaves(tree: Dict, c: Dict) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf of `tree`, in draw order."""
    out = []
    for path, *_ in leaf_specs(c):
        out.append((".".join(path), _node(tree, path, False)[path[-1]]))
    return out


def tree_of(c: Dict, tensors: List[torch.Tensor]) -> Dict:
    """The tree of configuration `c` holding `tensors`, given in draw
    order."""
    tree: Dict = {}
    for (path, *_), x in zip(leaf_specs(c), tensors):
        _node(tree, path, True)[path[-1]] = x
    return tree
