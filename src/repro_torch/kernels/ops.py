"""The attention kernels' wrappers: the only entry points the model layer
calls.

Each wrapper dispatches on the device of its inputs. On CPU tensors it runs
the kernel's plain PyTorch version from `kernels/ref.py`. On CUDA tensors it
checks device, dtype, shape and strides, allocates the output with
`torch.empty`, launches its hand-written CUDA kernel on the current stream
and raises if the launch fails; there is no fallback. `launches[name]`
counts the kernel launches, so a run can show that it went through them.

Layouts are the JAX package's (`repro.kernels.ops`). The kernels read
their inputs through the strides, so the wrappers make no transposed or
contiguous copies; they need the last dimension contiguous, every other
stride and the head dims a multiple of 16 bytes, and 16-byte aligned data.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

launches: Dict[str, int] = {"flash_decode": 0, "prefill_attention": 0,
                            "flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448        # bytes of shared memory a block may use on sm_90
_BLOCK_K = 64               # keys per tile (csrc/attention_common.cuh)
_ROWS = 32                  # query rows per block of prefill/flash attention
_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_ll = ctypes.c_longlong


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _smem_bytes(rows: int, dk: int, dv: int) -> int:
    return 4 * (rows * dk + _BLOCK_K * (dk + 1) + _BLOCK_K * dv
                + rows * _BLOCK_K + rows * dv + 3 * rows)


def _check(name: str, tensors: Dict[str, torch.Tensor], rows: int, dk: int,
           dv: int) -> int:
    """Validate the CUDA operands of kernel `name`; returns its dtype code."""
    first = next(iter(tensors.values()))
    code = _DTYPE_CODE.get(first.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {first.dtype} not supported "
                        f"(float32 or bfloat16)")
    vec = 16 // first.element_size()
    if dk % vec or dv % vec:
        raise ValueError(f"{name}: head dims ({dk}, {dv}) must be multiples "
                         f"of {vec} for {first.dtype}")
    for tn, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {tn} on {t.device}, expected "
                             f"{first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: {tn} is {t.dtype}, expected "
                            f"{first.dtype}")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name}: {tn} strides {t.stride()} need a "
                             f"contiguous last dim and 16-byte row strides")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tn} is not 16-byte aligned")
    if _smem_bytes(rows, dk, dv) > _SMEM_LIMIT:
        raise ValueError(f"{name}: {rows} rows x ({dk}, {dv}) head dims "
                         f"exceed the block's shared memory")
    return code


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_fns: Dict[str, ctypes._CFuncPtr] = {}


def _lib(name: str, symbol: str, argtypes):
    """The C entry point `symbol` of library `name`, built and loaded at
    first use, with its argument and return types declared."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

def flash_decode(q, k_cache, v_cache, lengths, *, scale: float):
    """One-token decode attention. q: (B,H,Dk); caches: (B,CL,KV,D) (a
    layer slice of the engine cache, read in place); lengths: (B,) valid
    slots per row (CL for a full ring). Returns (B,H,Dv) in q's dtype."""
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k_cache, v_cache, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, H, Dk = q.shape
    Bc, CL, KV, Dk2 = k_cache.shape
    Dv = v_cache.shape[-1]
    if (Bc != B or Dk2 != Dk or v_cache.shape[:3] != k_cache.shape[:3]
            or H % KV or tuple(lengths.shape) != (B,)):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    rep = H // KV
    code = _check("flash_decode", {"q": q, "k_cache": k_cache,
                                   "v_cache": v_cache}, rep, Dk, Dv)
    if lengths.device != q.device:
        raise ValueError("flash_decode: lengths must be on q's device")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    fn = _lib("decode_attention", "repro_flash_decode",
              [_i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f]
              + [_ll] * 10 + [_vp])
    with torch.cuda.device(q.device):
        err = fn(code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, KV, rep, CL, Dk, Dv,
                 float(scale), q.stride(0), q.stride(1), k_cache.stride(0),
                 k_cache.stride(1), k_cache.stride(2), v_cache.stride(0),
                 v_cache.stride(1), v_cache.stride(2), out.stride(0),
                 out.stride(1), _stream(q))
    _raise_on("flash_decode", err)
    launches["flash_decode"] += 1
    return out


# ---------------------------------------------------------------------------
# prefill_attention
# ---------------------------------------------------------------------------

def prefill_attention(q, k_chunk, v_chunk, k_cache, v_cache, offset: int, *,
                      scale: float):
    """Chunked-prefill attention: a C-token chunk against the cache prefix
    (ring rule) and causally against its own K/V. q: (B,C,H,Dk);
    k_chunk/v_chunk: (B,C,KV,D); caches: (B,CL,KV,D) in their pre-chunk
    state; offset: absolute position of the chunk's first token (a host
    int). Returns (B,C,H,Dv)."""
    offset = int(offset)
    if q.device.type == "cpu":
        return ref.prefill_attention_ref(q, k_chunk, v_chunk, k_cache,
                                         v_cache, offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    B, C, H, Dk = q.shape
    CL, KV = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    if (k_cache.shape != (B, CL, KV, Dk) or v_cache.shape[:3] != (B, CL, KV)
            or k_chunk.shape != (B, C, KV, Dk)
            or v_chunk.shape != (B, C, KV, Dv) or H % KV or C > CL
            or offset < 0):
        raise ValueError(
            f"prefill_attention: shapes q {tuple(q.shape)}, k_chunk "
            f"{tuple(k_chunk.shape)}, v_chunk {tuple(v_chunk.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, offset {offset}")
    rep = H // KV
    code = _check("prefill_attention",
                  {"q": q, "k_chunk": k_chunk, "v_chunk": v_chunk,
                   "k_cache": k_cache, "v_cache": v_cache}, _ROWS, Dk, Dv)
    out = torch.empty((B, C, H, Dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *k_chunk.stride()[:3], *v_chunk.stride()[:3], *out.stride()[:3])
    fn = _lib("prefill_attention", "repro_prefill_attention",
              [_i, _vp, _vp, _vp, _vp, _vp, _vp] + [_i] * 8 + [_f, _i, _vp, _vp])
    with torch.cuda.device(q.device):
        err = fn(code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 k_chunk.data_ptr(), v_chunk.data_ptr(), out.data_ptr(), B, C,
                 KV, rep, CL, Dk, Dv, offset, float(scale), _ROWS,
                 ctypes.cast(strides, ctypes.c_void_p), _stream(q))
    _raise_on("prefill_attention", err)
    launches["prefill_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, scale: float, window: int = 0):
    """Full-sequence causal GQA attention. q: (B,H,S,Dk); k,v:
    (B,KV,S,Dk/Dv) with GQA via h // rep; `window > 0` adds the
    sliding-window mask i - j < window. Returns (B,H,S,Dv). Any S."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, S, Dk = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    if (k.shape != (B, KV, S, Dk) or v.shape[:3] != (B, KV, S) or H % KV
            or window < 0):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    code = _check("flash_attention", {"q": q, "k": k, "v": v}, _ROWS, Dk, Dv)
    out = torch.empty((B, H, S, Dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _lib("flash_attention", "repro_flash_attention",
              [_i, _vp, _vp, _vp, _vp] + [_i] * 7 + [_f, _i, _vp, _vp])
    with torch.cuda.device(q.device):
        err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, H, S, H // KV, Dk, Dv, int(window),
                 float(scale), _ROWS, ctypes.cast(strides, ctypes.c_void_p),
                 _stream(q))
    _raise_on("flash_attention", err)
    launches["flash_attention"] += 1
    return out
