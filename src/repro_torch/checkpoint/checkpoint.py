"""Tree checkpointing into an .npz, the port's copy of the JAX package's
`checkpoint/checkpoint.py`: the same keys, the same content checksum and
the same atomic replace, so a float32 checkpoint written by either package
restores in the other.

Keys are the JAX package's key paths joined by '/': a dict key as itself,
a list index as its number, a NamedTuple field as '.' + its name (the
string of JAX's `GetAttrKey`). A TrainState gives `.params/...`,
`.opt/.step`, `.opt/.m/...`, `.opt/.v/...` and `.version`.

bfloat16 leaves are stored as raw 2-byte values, which is what numpy makes
of the JAX package's `ml_dtypes.bfloat16` arrays too; the checksum tags
them as "bfloat16" so that it survives the round trip.
"""
from __future__ import annotations

import os
import zipfile
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.weights import tree_flatten, tree_unflatten


class CheckpointError(ValueError):
    """Checkpoint file unusable: corrupt archive, missing/unexpected keys,
    shape mismatch against the restore target, or content-checksum
    mismatch."""


# reserved key holding the crc32 content checksum of every other entry
_CRC_KEY = "__content_crc32__"


def _dtype_tag(arr: np.ndarray) -> str:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return "bfloat16"
    if arr.dtype.name == "bfloat16":
        return "bfloat16"
    return arr.dtype.str


def _content_crc(flat: Dict[str, np.ndarray]) -> int:
    """crc32 over (key, dtype, shape, bytes) of every entry in sorted key
    order."""
    crc = 0
    for key in sorted(k for k in flat if k != _CRC_KEY):
        arr = np.ascontiguousarray(flat[key])
        head = f"{key}|{_dtype_tag(arr)}|{arr.shape}".encode()
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(head, crc))
    return crc


def _norm(path: str) -> str:
    """`np.savez` appends '.npz' to bare paths; normalize so `save(p)` and
    `load(p)` round-trip with the same `p` either way."""
    return path if path.endswith(".npz") else path + ".npz"


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _paths(getattr(tree, f), f"{prefix}.{f}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _paths(x, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save(path: str, tree) -> None:
    """Atomic save: write to a sibling temp file, fsync, then `os.replace`,
    so a crash leaves either the old complete checkpoint or the new one. A
    content checksum over every entry rides along."""
    path = _norm(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _paths(tree)}
    flat[_CRC_KEY] = np.asarray(_content_crc(flat), np.int64)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _read(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return dict(data)


def load(path: str, like) -> Any:
    """Restore into the structure of `like`, a tree of tensors (their
    shapes, dtypes and devices are kept). Raises CheckpointError naming
    missing/unexpected keys or mismatched shapes, or on a checksum
    mismatch."""
    path = _norm(path)
    try:
        flat = _read(path)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, ValueError, OSError, EOFError,
            KeyError) as e:
        raise CheckpointError(
            f"corrupt or unreadable checkpoint {path!r}: "
            f"{type(e).__name__}: {e}") from e
    stored_crc = flat.pop(_CRC_KEY, None)
    if stored_crc is not None and int(stored_crc) != _content_crc(flat):
        raise CheckpointError(
            f"checkpoint {path!r} failed content-checksum verification "
            f"(bit rot or torn write)")
    want = dict(_paths(like))
    missing = sorted(set(want) - set(flat))
    unexpected = sorted(set(flat) - set(want))
    if missing or unexpected:
        raise CheckpointError(
            f"checkpoint {path!r} does not match the restore target: "
            f"missing keys {missing}, unexpected keys {unexpected}")
    bad_shapes = [
        f"{k}: checkpoint {flat[k].shape} vs target {tuple(leaf.shape)}"
        for k, leaf in want.items()
        if tuple(flat[k].shape) != tuple(leaf.shape)]
    if bad_shapes:
        raise CheckpointError(
            f"checkpoint {path!r} shape mismatch: " + "; ".join(bad_shapes))
    return tree_unflatten(tree_flatten(like)[1],
                          [_to_tensor(flat[k], leaf)
                           for k, leaf in _paths(like)])


def verify(path: str) -> bool:
    """True iff `path` is a readable checkpoint whose content checksum
    (when present) matches."""
    try:
        flat = _read(_norm(path))
    except (FileNotFoundError, zipfile.BadZipFile, ValueError, OSError,
            EOFError, KeyError):
        return False
    stored = flat.pop(_CRC_KEY, None)
    return stored is None or int(stored) == _content_crc(flat)
