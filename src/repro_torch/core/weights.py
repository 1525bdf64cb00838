"""Param-tree helpers for the engine's streamed weight updates: flattening in
the JAX package's leaf order, byte-balanced chunk spans and the chunk and
stream checksums.

`tree_flatten` orders leaves as `jax.tree_util.tree_flatten` does (dict keys
sorted, lists in order) and tensors are sized by `numel() * element_size()`,
so the two packages compute the same span table and the same checksums for
the same tree.
"""
from __future__ import annotations

import struct
import zlib
from typing import Any, List, Sequence, Tuple

_LEAF = object()


def _rebuild(node, items):
    """A list, tuple or NamedTuple like `node` holding `items`."""
    if hasattr(node, "_fields"):
        return type(node)(*items)
    return type(node)(items)


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) with leaves in sorted-key / list order."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _flatten(node, leaves: List[Any]):
    # module-level, not a closure: a recursive nested function is a
    # reference cycle that would keep `leaves` (the tensors) alive until
    # the cyclic garbage collector runs
    if isinstance(node, dict):
        return {k: _flatten(node[k], leaves) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return _rebuild(node, [_flatten(v, leaves) for v in node])
    leaves.append(node)
    return _LEAF


def tree_unflatten(treedef, leaves: Sequence[Any]):
    return _unflatten(treedef, iter(leaves))


def _unflatten(node, it):
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return _rebuild(node, [_unflatten(v, it) for v in node])
    return next(it)


def _nbytes(x) -> int:
    return int(x.numel() * x.element_size())


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors."""
    return sum(_nbytes(x) for x in tree_flatten(tree)[0])


def chunk_spans(leaves: Sequence[Any], n_chunks: int) -> List[Tuple[int, int]]:
    """Partition a leaf list into <= n_chunks contiguous, byte-balanced
    [lo, hi) spans — the layer-chunked publication unit of the streamed
    broadcast. Leaf granularity keeps the swap trivially exact (a leaf is
    never split across chunks)."""
    n_chunks = max(int(n_chunks), 1)
    sizes = [_nbytes(x) for x in leaves]
    total = sum(sizes)
    if not leaves:
        return []
    target = total / n_chunks
    spans: List[Tuple[int, int]] = []
    lo, acc = 0, 0
    for i, s in enumerate(sizes):
        acc += s
        # close the span once it reaches the byte target, keeping enough
        # leaves for the remaining chunks to be non-empty
        remaining_chunks = n_chunks - len(spans)
        remaining_leaves = len(leaves) - (i + 1)
        if (acc >= target and remaining_chunks > 1) or \
                remaining_leaves < remaining_chunks - 1:
            if i + 1 > lo:
                spans.append((lo, i + 1))
                lo, acc = i + 1, 0
        if len(spans) == n_chunks - 1:
            break
    if lo < len(leaves):
        spans.append((lo, len(leaves)))
    return spans


def span_bytes(leaves: Sequence[Any],
               spans: Sequence[Tuple[int, int]]) -> List[int]:
    return [sum(_nbytes(x) for x in leaves[lo:hi]) for lo, hi in spans]


def chunk_token(version: int, k: int, nbytes: int) -> int:
    """Integrity checksum carried with streamed chunk `k` of publication
    `version`. Sender and receiver compute it independently from the
    publication identity and their own span tables (`chunk_spans` is
    deterministic, so both sides agree on `nbytes`); a damaged
    transmission surfaces as a token mismatch and is rejected before it
    can touch the shadow buffer."""
    return zlib.crc32(struct.pack("<qqq", int(version), int(k),
                                  int(nbytes)))


def stream_digest(tokens: Sequence[int]) -> int:
    """Whole-publication checksum: CRC over the in-order chunk tokens,
    verified immediately before the pointer swap, so a torn or
    misassembled stream can never install."""
    d = 0
    for t in tokens:
        d = zlib.crc32(struct.pack("<q", int(t)), d)
    return d
