"""Random weights from a seed, in the port's parameter layout, made by the
benchmark itself: one normal draw per stacked leaf on the device, in the
type the model is served in. The plain reference calls the same function
with the same seed to get the same numbers; it takes no weight from the
program.

The layout, the port's tree, is the architecture's
(`rlbench/arch/<model_type>.py` `leaf_specs`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from rlbench import arch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_specs(c: Dict) -> List[Tuple[Tuple[str, ...], tuple, str, float]]:
    """(path, shape, dtype name, init scale) of every leaf, in draw order:
    the architecture's layout. Scale: the std of a normal draw; 0.0 zeros;
    -1.0 ones."""
    return arch.of(c).leaf_specs(c)


def _node(tree: Dict, path: Tuple[str, ...], make: bool):
    """The dict that holds the leaf at `path` (a key of digits indexes the
    list of layer groups: the port's `groups[i]`, one a kind of layer)."""
    node = tree
    for key in path[:-1]:
        if key.isdigit():
            i = int(key)
            while make and len(node) <= i:
                node.append({})
            node = node[i]
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
