"""The kernels' wrappers: the only entry points the model layer calls.

Each wrapper dispatches on the device of its inputs. On CPU tensors it runs
the kernel's plain PyTorch version from `kernels/ref.py`. On CUDA tensors it
checks device, dtype, shape and strides, allocates the output with
`torch.empty`, launches its hand-written CUDA kernel on the current stream
and raises if the launch fails; there is no fallback. `launches[name]`
counts the kernel launches, so a run can show that it went through them.

Layouts are the JAX package's (`repro.kernels.ops`). The kernels read
their inputs through the strides, so the wrappers make no transposed or
contiguous copies, with one exception: the bfloat16 fused loss reads its
operands by TMA, which needs 16-byte row strides, so a head (or hidden)
whose rows are not (granite's untied (2048, 49155) head) is copied into
an aligned staging buffer first (`_tc_operand`). The attention kernels
need the last dimension contiguous, every other stride and the head dims
a multiple of 16 bytes, and 16-byte aligned data; they have no backward
(neither have the Pallas kernels), so on the card they refuse inputs that
autograd would differentiate rather than cut the gradient silently.
`prefill_attention` and `flash_attention` dispatch on the dtype (`route`):
bfloat16 launches the tensor-core kernel (wgmma on TMA-fed tiles; head
dims multiples of 16 up to 256, and for `prefill_attention` past that up
to absorbed MLA's 576 / 512 in its wide instance) and float32 the
CUDA-core kernel; a shape the kernel does not take raises
(`_prefill_geometry` says which instance a prefill shape takes).
`fused_logprob` is a `torch.autograd.Function` whose forward and backward
are kernels, routed likewise: bfloat16 on the tensor cores
(csrc/fused_logprob.cu, namespace flp_tc), float32 on the CUDA cores.
`ssd_scan` is forward-only like the attention kernels (the Pallas kernel
has no backward either), routed by dtype: bfloat16 on the tensor cores
with mma.sync behind a cp.async ring of chunks ("mma"), float32 on the CUDA
cores; `_ssd_geometry` chooses the chunk it walks, its heads per block and
shared memory from the shapes.
`flash_decode` and `flash_decode_paged` share one split-KV kernel body
(csrc/decode_common.cuh), routed by dtype: bfloat16 on the tensor cores
with mma.sync ("mma"; head dims multiples of 16 up to 256), float32 on the
CUDA cores (multiples of 4 up to 256). `_decode_geometry` chooses their splits,
groups of query heads and shared memory from the shapes alone; the splits of a row run as one thread-block cluster and merge in
shared memory, so the wrapper allocates nothing but the output.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

launches: Dict[str, int] = {"flash_decode": 0, "flash_decode_paged": 0,
                            "prefill_attention": 0, "flash_attention": 0,
                            "fused_logprob_fwd": 0, "fused_logprob_bwd": 0,
                            "ssd_scan": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448        # bytes of shared memory a block may use on sm_90
_BLOCK_K = 64               # keys per tile (csrc/attention_common.cuh)
_ROWS = 32                  # query rows per block of the float32 prefill/flash
# the float32 prefill's (rows, keys per tile), the first that fits: past
# 256 (absorbed MLA's 576 / 512) 16 rows and 32-key tiles
_F32_TILES = ((_ROWS, _BLOCK_K), (16, 32))
# the split-KV decode kernels (csrc/decode_common.cuh): 4 warps, each with
# 16 keys of a tile in bfloat16 (mma.sync, query heads padded to 16) and 8
# in float32 (CUDA cores), a ring of two tiles, head dims up to 256; as
# many splits as fill the card's resident blocks once
_DEC_WARPS = 4
_DEC_STAGES = 2             # tiles in the ring (kStages)
_DEC_MAX_DIM = 256
_SM_SMEM = 233472           # shared memory of an SM (1 KB of it per block)
_SM_BLOCKS = 4              # resident blocks an SM is counted for at most
_DEC_MAX_SPLITS = 8         # a row's splits are one cluster: 8 blocks at most
# the bfloat16 prefill/flash kernels on tensor cores (csrc/attention_tc.cuh):
# 64-column panels of a head dim, 128 query rows and 64-key tiles per block,
# a ring of at most 4 K/V stages, head dims multiples of 16 up to 256; the
# wide instance of prefill_attention: 64 rows shared by both consumer
# warpgroups, 32-key tiles, its 9 K and 8 V panels reserved (Dk up to 576,
# Dv up to 512)
_TC_MAX_STAGES = 4
_TC_MAX_DIM = 256
_TC_WIDE_ROWS, _TC_WIDE_KEYS = 64, 32
_TC_WIDE_MAX = (576, 512)
_TENSOR_CORE = ("prefill_attention", "flash_attention", "fused_logprob_fwd",
                "fused_logprob_bwd")
_MMA = ("flash_decode", "flash_decode_paged", "ssd_scan")
_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_ll = ctypes.c_longlong


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _smem_bytes(rows: int, dk: int, dv: int, keys: int = _BLOCK_K) -> int:
    """Shared memory of a block of the float32 prefill and flash kernels
    (csrc/attention_common.cuh `smem_bytes`) with `rows` query rows and
    `keys` keys per tile."""
    return 4 * (rows * dk + keys * (dk + 1) + keys * dv + rows * keys
                + rows * dv + 3 * rows)


def route(name: str, dtype: torch.dtype) -> str:
    """The kernel a CUDA tensor of `dtype` takes in wrapper `name`: "wgmma"
    (the tensor-core attention and fused-loss kernels, bfloat16), "mma"
    (the bfloat16 builds of the decode kernels and the SSD scan: mma.sync
    on the tensor cores) or "cuda-core"."""
    if dtype == torch.bfloat16 and name in _TENSOR_CORE:
        return "wgmma"
    if dtype == torch.bfloat16 and name in _MMA:
        return "mma"
    return "cuda-core"


def _ring(pk: int, pv: int, rows: int, keys: int) -> tuple:
    """(ring stages, shared-memory bytes) of a tensor-core attention block
    with pk Q/K and pv V panels of 64 columns, `rows` query rows and
    `keys`-key tiles, as csrc/attention_tc.cuh `ring_geometry` computes
    them: 1024 bytes of alignment slack, the Q panels, the mbarriers, then
    as many K/V stages as fit, at most 4."""
    fixed = 1024 + pk * rows * 128 + 16 * _TC_MAX_STAGES
    stage = (pk + pv) * keys * 128
    stages = min(_TC_MAX_STAGES, (_SMEM_LIMIT - fixed) // stage)
    return stages, fixed + stages * stage


def _tc_geometry(dk: int, dv: int) -> tuple:
    """(ring stages, shared-memory bytes) of a block of the tensor-core
    attention kernels for head dims (dk, dv), as csrc/attention_tc.cuh
    `geometry` computes them: 128 rows, 64-key tiles. Raises ValueError for
    head dims the kernels do not take."""
    if any(d <= 0 or d % 16 or d > _TC_MAX_DIM for d in (dk, dv)):
        raise ValueError(f"head dims ({dk}, {dv}) must be multiples of 16 "
                         f"up to {_TC_MAX_DIM} for the tensor-core kernel")
    stages, smem = _ring(-(-dk // 64), -(-dv // 64), 128, 64)
    if stages < 2:
        raise ValueError(f"head dims ({dk}, {dv}) leave no room for two K/V "
                         f"stages in the block's shared memory")
    return stages, smem


def _tc_wide_geometry(dk: int, dv: int) -> tuple:
    """(ring stages, shared-memory bytes) of a block of prefill_attention's
    wide tensor-core instance (csrc/attention_tc.cuh `wide_geometry`): 64
    rows, 32-key tiles, 9 Q/K and 8 V panels whatever the head dims. Raises
    ValueError for head dims it does not take."""
    mk, mv = _TC_WIDE_MAX
    if dk <= 0 or dv <= 0 or dk % 16 or dv % 16 or dk > mk or dv > mv:
        raise ValueError(f"head dims ({dk}, {dv}) must be multiples of 16 "
                         f"up to ({mk}, {mv}) for the wide tensor-core "
                         f"prefill kernel")
    return _ring(mk // 64, mv // 64, _TC_WIDE_ROWS, _TC_WIDE_KEYS)


class PrefillGeometry(NamedTuple):
    """The prefill_attention kernel a shape takes: "tc" (tensor cores,
    128 rows, 64-key tiles), "tc-wide" (tensor cores, 64 rows shared by
    both consumer warpgroups, 32-key tiles) or "cuda-core" (float32)."""
    kernel: str
    rows: int        # query rows of a block
    keys: int        # keys of a K/V tile
    stages: int      # K/V stages in shared memory (1 on the CUDA cores)
    smem: int        # dynamic shared memory of a block, bytes


def _prefill_geometry(dk: int, dv: int, dtype: torch.dtype
                      ) -> PrefillGeometry:
    """The prefill_attention kernel for head dims (dk, dv) in `dtype`, from
    the shapes alone: bfloat16 up to 256 the tensor-core kernel, past it
    the wide instance; float32 the first of `_F32_TILES` that fits the
    block's shared memory. Raises ValueError for head dims none takes."""
    if dtype == torch.bfloat16:
        if max(dk, dv) <= _TC_MAX_DIM:
            return PrefillGeometry("tc", 128, 64, *_tc_geometry(dk, dv))
        return PrefillGeometry("tc-wide", _TC_WIDE_ROWS, _TC_WIDE_KEYS,
                               *_tc_wide_geometry(dk, dv))
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if dk <= 0 or dv <= 0 or dk % vec or dv % vec:
        raise ValueError(f"head dims ({dk}, {dv}) must be multiples of {vec} "
                         f"for {dtype}")
    for rows, keys in _F32_TILES:
        smem = _smem_bytes(rows, dk, dv, keys)
        if smem <= _SMEM_LIMIT:
            return PrefillGeometry("cuda-core", rows, keys, 1, smem)
    raise ValueError(f"head dims ({dk}, {dv}) exceed the block's shared "
                     f"memory at {_F32_TILES[-1][0]} rows and "
                     f"{_F32_TILES[-1][1]}-key tiles")


class DecodeGeometry(NamedTuple):
    """A launch of the split-KV decode kernel (csrc/decode_common.cuh)."""
    span: int        # keys per split
    splits: int      # the grid's splits, one cluster: ceil(keys / span)
    tile: int        # keys per ring tile (4 warps' worth)
    groups: int      # blocks per KV head, each with `rows` query heads
    rows: int
    rows_pad: int    # rows of the block's scratch (float32: the kernel
                     # instance, rows rounded up to a power of two)
    table: int       # block-table entries a block keeps (paged; 0: slots)
    head_bytes: int  # q and the table slice, 16-byte aligned
    smem: int        # dynamic shared memory of a block, bytes


def _decode_geometry(keys: int, rep: int, dk: int, dv: int,
                     dtype: torch.dtype, page_size: int = 0, batch: int = 1,
                     kv: int = 1, sms: int = 132) -> DecodeGeometry:
    """The decode kernels' launch for `batch` rows of `keys` cache
    positions (CL, or NB * PS for the paged kernel), `kv` KV heads of `rep`
    query heads each and head dims (dk, dv) on a card of `sms` SMs, from
    the shapes alone. Shared memory as csrc/decode_common.cuh carves it: q
    (bfloat16: the mma's 16-row tile; float32: the rows), the block-table
    slice of a split, then the ring of two tiles in `dtype` (rows padded
    by 16 bytes), which the end-of-split scratch reuses. The splits of a row are
    one thread-block cluster: a power of two of them, at most 8, as many as
    keep the grid within one wave of the blocks the SMs hold at once
    (counted without the page table, so that the slot and paged kernels
    get the same splits and tiles for the same shapes), each a multiple of
    64 keys. Raises ValueError for head dims the kernels do not take."""
    size = torch.empty((), dtype=dtype).element_size()
    mult = 16 if size == 2 else 4     # the mma's k16 step; 16 bytes
    if any(d <= 0 or d % mult or d > _DEC_MAX_DIM for d in (dk, dv)):
        raise ValueError(f"head dims ({dk}, {dv}) must be multiples of {mult} "
                         f"up to {_DEC_MAX_DIM} for {dtype}")
    if keys <= 0 or rep <= 0:
        raise ValueError(f"{keys} cache positions, {rep} heads per KV head")
    kw, max_rows = (16, 16) if size == 2 else (8, 8)
    groups = -(-rep // max_rows)
    heads = -(-rep // groups)
    rows_pad = heads if size == 2 else 1 << (heads - 1).bit_length()
    q_bytes = 16 * (2 * dk + 16) if size == 2 else 4 * rows_pad * dk

    def head_bytes(table):
        return -(-(q_bytes + 4 * table) // 16) * 16

    ring = _DEC_STAGES * _DEC_WARPS * kw * (dk * size + dv * size + 32)
    scratch = 4 * rows_pad * ((_DEC_WARPS + 1) * dv + 3 * _DEC_WARPS + 2)
    per_sm = max(1, min(_SM_BLOCKS, _SM_SMEM // (head_bytes(0)
                                                 + max(ring, scratch) + 1024)))
    fit = max(1, sms * per_sm // (batch * kv * groups))
    splits = min(_DEC_MAX_SPLITS, 1 << (fit.bit_length() - 1))
    span = -(-(-(-keys // splits)) // 64) * 64
    table = span // page_size + 2 if page_size else 0
    head = head_bytes(table)
    if head + max(ring, scratch) > _SMEM_LIMIT:
        raise ValueError(f"head dims ({dk}, {dv}) leave no room for two "
                         f"stages in the block's shared memory")
    return DecodeGeometry(span, -(-keys // span), _DEC_WARPS * kw, groups,
                          heads, rows_pad, table, head,
                          head + max(ring, scratch))


_sms: Dict[torch.device, int] = {}


def _sm_count(device: torch.device) -> int:
    """The SM count of `device`, read once."""
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


class _DecodeParams(ctypes.Structure):
    """csrc/decode_common.cuh `Params`, field by field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "table", "lengths",
                                        "out")]
        + [(n, ctypes.c_longlong) for n in ("q_sb", "q_sh", "k_s0", "k_ss",
                                            "k_sh", "v_s0", "v_ss", "v_sh",
                                            "o_sb", "o_sh")]
        + [(n, ctypes.c_int) for n in ("B", "KV", "rep", "nrg", "rows",
                                       "rmax", "keys", "dk", "dv", "span",
                                       "nsplit", "head_bytes", "smem", "ps",
                                       "ps_shift", "nb")]
        + [("scale", ctypes.c_float)])


def _check(name: str, tensors: Dict[str, torch.Tensor], rows: Optional[int],
           dk: int, dv: int) -> int:
    """Validate the CUDA operands of kernel `name`; returns its dtype code.
    Head dims and shared memory are checked against the kernel the dtype
    takes (`route`): the tensor-core one's geometry, or the CUDA-core one's
    `rows` query rows per block (None: the caller checks its kernel's
    geometry itself)."""
    first = next(iter(tensors.values()))
    code = _DTYPE_CODE.get(first.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {first.dtype} not supported "
                        f"(float32 or bfloat16)")
    vec = 16 // first.element_size()
    tensor_core = route(name, first.dtype) == "wgmma"
    if tensor_core and rows is not None:
        try:
            _tc_geometry(dk, dv)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    elif dk % vec or dv % vec:
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
    if (not tensor_core and rows is not None
            and _smem_bytes(rows, dk, dv) > _SMEM_LIMIT):
        raise ValueError(f"{name}: {rows} rows x ({dk}, {dv}) head dims "
                         f"exceed the block's shared memory")
    return code


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    """The attention kernels and `ssd_scan` have no backward: a
    differentiated call would return an output with no autograd history and
    cut the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only, and an input requires "
            f"grad; run it under torch.no_grad() (training takes the plain "
            f"paths: packed-batch attention in models/attention.py, the "
            f"chunked SSD in models/ssm.py)")


_MAP_ERROR = 10000           # csrc/attention_tc.cuh kMapError


def _raise_on(name: str, err: int) -> None:
    if err >= _MAP_ERROR:
        raise RuntimeError(f"{name}: TMA tensor map encoding failed with "
                           f"CUresult {err - _MAP_ERROR}")
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
# flash_decode and flash_decode_paged: one split-KV kernel body
# ---------------------------------------------------------------------------

def _decode_launch(name, lib, symbol, q, k, v, table, lengths, keys: int,
                   page_size: int, k_strides, v_strides, scale: float):
    """Check, allocate and launch one of the two decode kernels. k_strides
    and v_strides: (row or page, position or page offset, KV head)."""
    _forward_only(name, q, k, v)
    B, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    rep = H // KV
    code = _check(name, {"q": q, "k": k, "v": v}, None, Dk, Dv)
    try:
        geo = _decode_geometry(keys, rep, Dk, Dv, q.dtype, page_size, B, KV,
                               _sm_count(q.device))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    tensors = [lengths] if table is None else [table, lengths]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: block_tables and lengths must be on q's "
                         f"device")
    lengths = lengths.to(torch.int32).contiguous()
    if table is not None:
        table = table.to(torch.int32).contiguous()
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    shift = page_size.bit_length() - 1 if page_size else 0
    p = _DecodeParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        table=table.data_ptr() if table is not None else None,
        lengths=lengths.data_ptr(), out=out.data_ptr(),
        q_sb=q.stride(0), q_sh=q.stride(1), k_s0=k_strides[0],
        k_ss=k_strides[1], k_sh=k_strides[2], v_s0=v_strides[0],
        v_ss=v_strides[1], v_sh=v_strides[2], o_sb=out.stride(0),
        o_sh=out.stride(1), B=B, KV=KV, rep=rep, nrg=geo.groups,
        rows=geo.rows, rmax=geo.rows_pad, keys=keys, dk=Dk, dv=Dv,
        span=geo.span, nsplit=geo.splits, head_bytes=geo.head_bytes,
        smem=geo.smem,
        ps=page_size, ps_shift=(shift if page_size == 1 << shift else -1),
        nb=table.shape[1] if table is not None else 0, scale=float(scale))
    fn = _lib(lib, symbol, [_i, _vp, _vp])
    with torch.cuda.device(q.device):
        err = fn(code, ctypes.addressof(p), _stream(q))
    _raise_on(name, err)
    launches[name] += 1
    return out


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
    if (Bc != B or Dk2 != Dk or v_cache.shape[:3] != k_cache.shape[:3]
            or H % KV or tuple(lengths.shape) != (B,)):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    return _decode_launch("flash_decode", "decode_attention",
                          "repro_flash_decode", q, k_cache, v_cache, None,
                          lengths, CL, 0, k_cache.stride()[:3],
                          v_cache.stride()[:3], scale)


def flash_decode_paged(q, k_pool, v_pool, block_tables, lengths, *,
                       scale: float):
    """One-token decode attention straight from the page pool. q: (B,H,Dk);
    pools: (NP,PS,KV,D) (a layer slice of the engine's (L,NP,PS,KV,D) pool,
    read in place); block_tables: (B,NB) page ids, logical position p of row
    b at page block_tables[b, p // PS], offset p % PS; lengths: (B,) valid
    logical positions per row. Returns (B,H,Dv) in q's dtype, equal bit for
    bit to `flash_decode` on the gathered (B, NB*PS, KV, D) view."""
    if q.device.type == "cpu":
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, block_tables,
                                          lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged: unsupported device {q.device}")
    B, H, Dk = q.shape
    NP, PS, KV, Dk2 = k_pool.shape
    NB = block_tables.shape[-1]
    if (Dk2 != Dk or v_pool.shape[:3] != k_pool.shape[:3] or H % KV
            or tuple(block_tables.shape) != (B, NB)
            or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"flash_decode_paged: shapes q {tuple(q.shape)}, k_pool "
            f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}, "
            f"block_tables {tuple(block_tables.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    return _decode_launch("flash_decode_paged", "paged_decode",
                          "repro_flash_decode_paged", q, k_pool, v_pool,
                          block_tables, lengths, NB * PS, PS,
                          k_pool.stride()[:3], v_pool.stride()[:3], scale)


# ---------------------------------------------------------------------------
# prefill_attention
# ---------------------------------------------------------------------------

def prefill_attention(q, k_chunk, v_chunk, k_cache, v_cache, offset: int, *,
                      scale: float):
    """Chunked-prefill attention: a C-token chunk against the cache prefix
    (ring rule) and causally against its own K/V. q: (B,C,H,Dk);
    k_chunk/v_chunk: (B,C,KV,D); caches: (B,CL,KV,D) in their pre-chunk
    state; offset: absolute position of the chunk's first token (a host
    int). Returns (B,C,H,Dv). Absorbed MLA calls it with KV = 1, Dk = r +
    rope, Dv = r; past 256 the kernel's wide instance takes it (Dk up to
    576, Dv up to 512, `_prefill_geometry`)."""
    offset = int(offset)
    if q.device.type == "cpu":
        return ref.prefill_attention_ref(q, k_chunk, v_chunk, k_cache,
                                         v_cache, offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    _forward_only("prefill_attention", q, k_chunk, v_chunk, k_cache, v_cache)
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
                   "k_cache": k_cache, "v_cache": v_cache}, None, Dk, Dv)
    try:
        geo = _prefill_geometry(Dk, Dv, q.dtype)
    except ValueError as e:
        raise ValueError(f"prefill_attention: {e}") from None
    out = torch.empty((B, C, H, Dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *k_chunk.stride()[:3], *v_chunk.stride()[:3], *out.stride()[:3])
    fn = _lib("prefill_attention", "repro_prefill_attention",
              [_i, _vp, _vp, _vp, _vp, _vp, _vp] + [_i] * 8
              + [_f, _i, _i, _vp, _vp])
    with torch.cuda.device(q.device):
        err = fn(code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 k_chunk.data_ptr(), v_chunk.data_ptr(), out.data_ptr(), B, C,
                 KV, rep, CL, Dk, Dv, offset, float(scale), geo.rows,
                 geo.keys, ctypes.cast(strides, ctypes.c_void_p), _stream(q))
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
    _forward_only("flash_attention", q, k, v)
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


# ---------------------------------------------------------------------------
# fused_logprob
# ---------------------------------------------------------------------------

_TILE = 128                 # rows and vocab columns of one tile (csrc)
_SCRATCH_BYTES = 1 << 28    # bound on the (N, Vc) logits-gradient chunk
_TC_PANEL = 64              # rows of a TMA panel (csrc/fused_logprob.cu)


def _fused_check(hidden, head, targets, transpose_head: bool):
    """Validate the CUDA operands of fused_logprob; returns (N, D, V, dtype
    code, strides) with the head's strides given as (d, v)."""
    if hidden.dim() != 2 or head.dim() != 2 or targets.dim() != 1:
        raise ValueError(f"fused_logprob: shapes hidden {tuple(hidden.shape)}, "
                         f"head {tuple(head.shape)}, targets "
                         f"{tuple(targets.shape)}")
    N, D = hidden.shape
    V = head.shape[0] if transpose_head else head.shape[1]
    if (head.shape[1] if transpose_head else head.shape[0]) != D \
            or targets.shape[0] != N:
        raise ValueError(f"fused_logprob: hidden {tuple(hidden.shape)}, head "
                         f"{tuple(head.shape)} (transpose_head="
                         f"{transpose_head}), targets {tuple(targets.shape)}")
    code = _DTYPE_CODE.get(hidden.dtype)
    if code is None or head.dtype != hidden.dtype:
        raise TypeError(f"fused_logprob: hidden {hidden.dtype}, head "
                        f"{head.dtype}; both float32 or both bfloat16")
    for t in (head, targets):
        if t.device != hidden.device:
            raise ValueError(f"fused_logprob: operands on {hidden.device} "
                             f"and {t.device}")
    sd, sv = head.stride()[::-1] if transpose_head else head.stride()
    strides = (ctypes.c_longlong * 4)(hidden.stride(0), hidden.stride(1),
                                      sd, sv)
    return N, D, V, code, strides


def _vocab_chunk(N: int, V: int, dtype=torch.float32) -> int:
    """Vocab columns per chunk of the backward's (N, Vc) logits-gradient
    scratch, 4 bytes an entry on both routes: float32 on the CUDA cores,
    two bfloat16 terms on the tensor cores. The tensor-core chunks are
    balanced: as few as the byte bound allows, of one width (a multiple of
    128), so no narrow last chunk costs a whole pass of the dh product."""
    full = -(-V // _TILE) * _TILE
    fit = max(_TILE, _SCRATCH_BYTES // 4 // max(N, 1) // _TILE * _TILE)
    if dtype != torch.bfloat16:
        return min(full, fit)
    n = -(-V // fit)
    return min(full, -(-(-(-V // n)) // _TILE) * _TILE)


def _tc_splits(row_tiles: int, v_tiles: int, sms: int) -> int:
    """Vocab splits of the tensor-core forward. A block's ring of stages
    takes most of an SM's shared memory, so one block runs per SM: the
    splits are the count that minimises waves x vocab tiles per block (the
    fewest on a tie), with no split left without a tile."""
    best, best_n = None, 1
    for n in range(1, v_tiles + 1):
        per = -(-v_tiles // n)
        if (n - 1) * per >= v_tiles:
            continue
        cost = -(-row_tiles * n // sms) * per
        if best is None or cost < best:
            best, best_n = cost, n
    return best_n


def _tc_part_rows(N: int, dw_chunks: int) -> int:
    """Rows of each float32 dW partial on the tensor cores: N / dw_chunks
    rounded up to a TMA panel (64 rows), since a panel of hidden rows may
    not straddle two partials."""
    per = -(-N // max(int(dw_chunks), 1))
    return -(-per // _TC_PANEL) * _TC_PANEL


def _tc_operand(name: str, t):
    """A bfloat16 operand of the tensor-core fused loss as the kernels read
    it: 2-D, a contiguous inner dim, and its base and row stride multiples
    of 16 bytes, which a TMA map needs. Rows that are not aligned (granite's
    untied (2048, 49155) head: 98,310-byte rows) are copied into a staging
    buffer of ceil8(columns) columns, whose padding the kernels never read.
    A non-contiguous inner dim raises."""
    if t.dim() != 2:
        raise ValueError(f"fused_logprob: {name} must be 2-D, got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"fused_logprob: the tensor-core kernels take "
                        f"bfloat16 {name}, got {t.dtype}")
    rows, cols = t.shape
    if t.stride(1) != 1 and cols > 1:
        raise ValueError(f"fused_logprob: {name} strides {t.stride()}: the "
                         f"tensor-core kernels need a contiguous inner dim")
    if t.stride(1) == 1 and (t.stride(0) % 8 == 0 or rows == 1) \
            and t.data_ptr() % 16 == 0:
        return t
    staged = torch.empty((rows, -(-cols // 8) * 8), dtype=t.dtype,
                         device=t.device)
    staged[:, :cols].copy_(t)
    return staged


def _fused_fwd(hidden, head, targets, transpose_head: bool):
    N, D, V, code, strides = _fused_check(hidden, head, targets,
                                          transpose_head)
    dev = hidden.device
    tgt = targets.to(torch.int32).contiguous()
    lp, lse, ent = (torch.empty(N, dtype=torch.float32, device=dev)
                    for _ in range(3))
    row_tiles, v_tiles = -(-N // _TILE), -(-V // _TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if route("fused_logprob_fwd", hidden.dtype) == "wgmma":
        h = _tc_operand("hidden", hidden)
        w = _tc_operand("head", head)
        n_split = _tc_splits(row_tiles, v_tiles, sms)
        ws = torch.empty((4, n_split, N), dtype=torch.float32, device=dev)
        fn = _lib("fused_logprob", "repro_fused_logprob_fwd_tc",
                  [_vp, _vp, _i] + [_vp] * 5 + [_i] * 3 + [_ll, _ll, _i,
                                                          _vp])
        with torch.cuda.device(dev):
            err = fn(h.data_ptr(), w.data_ptr(), int(transpose_head),
                     tgt.data_ptr(), lp.data_ptr(), lse.data_ptr(),
                     ent.data_ptr(), ws.data_ptr(), N, D, V, h.stride(0),
                     w.stride(0), n_split, _stream(hidden))
    else:
        # enough (row tile, vocab split) blocks for two per SM
        n_split = max(1, min(v_tiles, -(-2 * sms // row_tiles)))
        ws = torch.empty((4, n_split, N), dtype=torch.float32, device=dev)
        fn = _lib("fused_logprob", "repro_fused_logprob_fwd",
                  [_i] + [_vp] * 7 + [_i] * 3 + [_vp, _i, _vp])
        with torch.cuda.device(dev):
            err = fn(code, hidden.data_ptr(), head.data_ptr(),
                     tgt.data_ptr(), lp.data_ptr(), lse.data_ptr(),
                     ent.data_ptr(), ws.data_ptr(), N, D, V,
                     ctypes.cast(strides, ctypes.c_void_p), n_split,
                     _stream(hidden))
    _raise_on("fused_logprob_fwd", err)
    launches["fused_logprob_fwd"] += 1
    return lp, lse, ent


def _row_args(targets, lse, c0, g_lp, g_ent):
    tgt = targets.to(torch.int32).contiguous()
    rows = [t.float().contiguous() for t in (lse, c0, g_lp, g_ent)]
    return [tgt] + rows


def fused_logprob_bwd(hidden, head, targets, lse, c0, g_lp, g_ent, *,
                      transpose_head: bool, dw_chunks: int = 1,
                      want_dh: bool = True, want_dw: bool = True):
    """(dhidden, dhead) from the saved lse and the row coefficients of
    `ref.logits_grad_coef`: dh (N, D) in the hidden dtype, dW in the head's
    layout and dtype, a gradient not wanted None. One launch computes each
    vocab chunk's logits gradient once and feeds both products. dw_chunks >
    1 cuts the rows into that many ranges (on the tensor cores, rounded up
    to 64 rows) whose float32 partials are summed here."""
    if not (want_dh or want_dw):
        return None, None
    N, D, V, code, strides = _fused_check(hidden, head, targets,
                                          transpose_head)
    dev = hidden.device
    rows = _row_args(targets, lse, c0, g_lp, g_ent)
    tensor_core = route("fused_logprob_bwd", hidden.dtype) == "wgmma"
    chunk = _vocab_chunk(N, V, hidden.dtype)
    per = (_tc_part_rows(N, dw_chunks) if tensor_core
           else -(-N // max(int(dw_chunks), 1)))
    n_parts = -(-N // per)
    # the logits gradient of a chunk: float32, or on the tensor cores its
    # two bfloat16 terms bf16(dl) and bf16(dl - bf16(dl))
    dl = (torch.empty((2, N, chunk), dtype=torch.bfloat16, device=dev)
          if tensor_core else
          torch.empty((N, chunk), dtype=torch.float32, device=dev))
    dh = acc = dw = None
    if want_dh:
        dh = torch.empty((N, D), dtype=hidden.dtype, device=dev)
        acc = torch.empty((N, D) if V > chunk else (0,), dtype=torch.float32,
                          device=dev)
    o_sd = o_sv = 0
    if want_dw:
        if n_parts > 1:
            dw = torch.empty((n_parts,) + tuple(head.shape),
                             dtype=torch.float32, device=dev)
        else:
            dw = torch.empty(tuple(head.shape), dtype=head.dtype, device=dev)
        o_sd, o_sv = dw.stride()[-2:][::-1] if transpose_head \
            else dw.stride()[-2:]
    outs = [None if x is None else x.data_ptr() for x in (dh, acc, dw)]
    with torch.cuda.device(dev):
        if tensor_core:
            h = _tc_operand("hidden", hidden)
            w = _tc_operand("head", head)
            fn = _lib("fused_logprob", "repro_fused_logprob_bwd_tc",
                      [_vp, _vp, _i] + [_vp] * 9 + [_i] * 3
                      + [_ll] * 4 + [_i, _i, _ll, _i, _vp])
            err = fn(h.data_ptr(), w.data_ptr(), int(transpose_head),
                     *(t.data_ptr() for t in rows), *outs, dl.data_ptr(),
                     N, D, V, h.stride(0), w.stride(0), o_sd, o_sv, per,
                     n_parts, D * V, chunk, _stream(hidden))
        else:
            fn = _lib("fused_logprob", "repro_fused_logprob_bwd",
                      [_i] + [_vp] * 11 + [_i] * 3
                      + [_vp, _ll, _ll, _i, _i, _ll, _i, _vp])
            err = fn(code, hidden.data_ptr(), head.data_ptr(),
                     *(t.data_ptr() for t in rows), *outs, dl.data_ptr(),
                     N, D, V, ctypes.cast(strides, ctypes.c_void_p), o_sd,
                     o_sv, per, n_parts, D * V, chunk, _stream(hidden))
    _raise_on("fused_logprob_bwd", err)
    launches["fused_logprob_bwd"] += 1
    if dw is not None and n_parts > 1:
        dw = dw.sum(0).to(head.dtype)
    return dh, dw


class _FusedLogprob(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, head, targets, transpose_head, dw_chunks):
        lp, lse, ent = _fused_fwd(hidden, head, targets, transpose_head)
        ctx.save_for_backward(hidden, head, targets, lse, ent)
        ctx.cfg = (transpose_head, dw_chunks)
        return lp, lse, ent

    @staticmethod
    def backward(ctx, g_lp, g_lse, g_ent):
        hidden, head, targets, lse, ent = ctx.saved_tensors
        transpose_head, dw_chunks = ctx.cfg
        c0, g_lp, g_ent = ref.logits_grad_coef(lse, ent, g_lp, g_lse, g_ent)
        dh, dw = fused_logprob_bwd(
            hidden, head, targets, lse, c0, g_lp, g_ent,
            transpose_head=transpose_head, dw_chunks=dw_chunks,
            want_dh=ctx.needs_input_grad[0], want_dw=ctx.needs_input_grad[1])
        return dh, dw, None, None, None


def fused_logprob(hidden, head, targets, *, transpose_head: bool = False,
                  dw_chunks: int = 1):
    """Blockwise linear-cross-entropy over the lm head. hidden: (N, D);
    head: (D, V), or (V, D) with transpose_head (the tied embedding, read in
    place); targets: (N,) integer ids. Returns (logprob, lse, entropy),
    each (N,) float32. Differentiable w.r.t. hidden and head: the backward
    recomputes each vocab chunk's softmax from the saved lse, so neither
    the (N, V) logits nor their gradient is ever stored whole. dw_chunks > 1
    sums the head gradient as per-row-range float32 partials."""
    if hidden.device.type == "cpu":
        return ref.fused_logprob_blocked(hidden, head, targets,
                                         transpose_head=transpose_head,
                                         dw_chunks=dw_chunks)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_logprob: unsupported device {hidden.device}")
    return _FusedLogprob.apply(hidden, head, targets, bool(transpose_head),
                               int(dw_chunks))


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

# the SSD scan (csrc/ssd_scan.cu): Q, N and P padded to 16 in shared memory,
# chunks of at most 64 tokens a block holds; bfloat16 takes one warp per 16
# columns of P for each of the block's heads and holds its slice of the
# state in registers (N up to 256, in blocks of at most 256 threads above
# N 128), float32 a 256-thread block per (row, head)
_SSD_PAD = 16
_SSD_MAX_Q = 64
_SSD_MMA_MAX_N = 256
_SSD_HEADS = (4, 2, 1)       # heads per bfloat16 block, in order of preference
_SSD_FMA_THREADS = 256
_SM_THREADS = 2048           # resident threads of an SM


class SsdGeometry(NamedTuple):
    """A launch of the SSD scan kernel (csrc/ssd_scan.cu)."""
    q: int           # the chunk the kernel walks, a divisor of the caller's
    heads: int       # heads per block, all of one B/C group
    threads: int     # per block
    qp: int          # q, N and P padded to 16
    np: int
    pp: int
    smem: int        # dynamic shared memory of a block, bytes
    blocks_per_sm: int  # resident blocks by shared memory and threads
    warps_per_sm: int   # (registers permitting)


def _ssd_geometry(h: int, p: int, g: int, n: int, chunk: int,
                  dtype: torch.dtype) -> SsdGeometry:
    """The SSD scan's launch for `h` heads of width `p` over `g` groups of
    state `n`, chunks of `chunk`, from the shapes alone. Shared memory as
    csrc/ssd_scan.cu `Layout` carves it: a ring of two stages [B][C][x of
    each head][dt of each head], rows padded by 16 bytes, then per head
    S' (bfloat16: hi and lo terms), A_cum (float64), exp(A_cum), w and the
    decay (float32: then the state). The kernel walks the largest divisor
    of `chunk` up to 64 whose tiles fit (the scan does not depend on its
    chunking but for rounding); bfloat16 takes the first of `_SSD_HEADS`
    heads per block that divides h / g and fits, float32 one.
    Raises ValueError for shapes the kernel does not take."""
    pad = lambda v: -(-v // _SSD_PAD) * _SSD_PAD  # noqa: E731
    np_, pp = pad(n), pad(p)
    size = torch.empty((), dtype=dtype).element_size()
    if size == 2 and np_ > _SSD_MMA_MAX_N:
        raise ValueError(f"N {n}: the bfloat16 kernel holds the state in "
                         f"registers, N up to {_SSD_MMA_MAX_N}")
    rowb, rowx = np_ * size + 16, pp * size + 16
    max_threads = 256 if np_ > 128 else 512
    rep = h // g
    heads = [k for k in _SSD_HEADS if rep % k == 0] if size == 2 else [1]
    for q in range(min(chunk, _SSD_MAX_Q), 0, -1):
        if chunk % q:
            continue
        qp = pad(q)
        rows = qp * size + 16
        if size == 2:
            head = 2 * qp * rows + 16 * qp + 16
        else:
            head = qp * rows + 16 * qp + 16 + np_ * rowx
        for k in heads:
            threads = 2 * pp * k if size == 2 else _SSD_FMA_THREADS
            smem = 2 * (2 * qp * rowb + k * (qp * rowx + 4 * qp)) + k * head
            if threads <= max_threads and smem <= _SMEM_LIMIT:
                blocks = min(_SM_SMEM // (smem + 1024),
                             _SM_THREADS // threads)
                return SsdGeometry(q, k, threads, qp, np_, pp, smem, blocks,
                                   blocks * threads // 32)
    threads = (f" and {max_threads} threads (P up to {max_threads // 2})"
               if size == 2 else "")
    raise ValueError(f"chunk {chunk}, N {n}, P {p}: the kernel's tiles do not "
                     f"fit a block's {_SMEM_LIMIT} bytes of shared "
                     f"memory{threads}")


def _aligned16(*ts: torch.Tensor) -> bool:
    """Whether each tensor's data and all strides but the last are 16-byte
    aligned, so the SSD scan copies its tiles by cp.async."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:-1]) for t in ts)


def _ssd_check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,)
            or tuple(B.shape[:2]) != (b, l) or C.shape != B.shape or g < 1
            or h % g or chunk < 1 or l % chunk or p % 8 or n % 8):
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
            f"chunk {chunk}: need l % chunk == 0, h % g == 0 and P, N "
            f"multiples of 8")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x {x.dtype}, B {B.dtype}, C {C.dtype}; "
                        f"all float32 or all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt {dt.dtype}, A {A.dtype}; both "
                        f"float32")


class _SsdParams(ctypes.Structure):
    """csrc/ssd_scan.cu `ssd::Params`, field by field."""
    _fields_ = ([(k, _vp) for k in ("x", "dt", "A", "B", "C", "y", "state")]
                + [(k, _ll) for k in ("x_sb", "x_sl", "x_sh", "dt_sb", "dt_sl",
                                      "dt_sh", "b_sb", "b_sl", "b_sg", "c_sb",
                                      "c_sl", "c_sg")]
                + [(k, _i) for k in ("batch", "L", "H", "P", "G", "N", "Q",
                                     "qp", "np", "pp", "heads", "aligned",
                                     "smem")])


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64):
    """Mamba2 SSD chunked scan: the intra-chunk attention form and the
    inter-chunk state recurrence. x: (b,l,h,p); dt: (b,l,h) float32
    (softplus'd); A: (h,) float32, negative; B, C: (b,l,g,n), head h
    reading group h // (h/g); l % chunk == 0, P and N multiples of 8.
    Returns y (b,l,h,p) in x's dtype and the final state (b,h,n,p)
    float32. x, B and C may be strided views (the model passes slices of
    one conv output) with their last dim contiguous; the kernel copies
    them by cp.async where their strides and data are 16-byte aligned.
    On the card, bfloat16 runs on the tensor cores (its products split
    float32 operands in two bf16 terms; N up to 256, P up to 256, or 128
    above N 128) and float32 on the CUDA cores (as far as the block's
    shared memory holds the state); the kernel walks a divisor of `chunk`
    up to 64 tokens long. The recurrence is reassociated across chunks:
    equal to `ref.ssd_scan_ref` to the dtype's tolerance, not bitwise."""
    chunk = int(chunk)
    _ssd_check(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    _forward_only("ssd_scan", x, dt, A, B, C)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    for tn, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {tn} on {t.device}, expected "
                             f"{x.device}")
    for tn, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {tn} strides {t.stride()} need a "
                             f"contiguous last dim")
    try:
        geo = _ssd_geometry(h, p, g, n, chunk, x.dtype)
    except ValueError as e:
        raise ValueError(f"ssd_scan: {e}") from None
    A = A.contiguous()
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    prm = _SsdParams(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), state.data_ptr(),
                     *x.stride()[:3], *dt.stride(), *B.stride()[:3],
                     *C.stride()[:3], b, l, h, p, g, n, geo.q, geo.qp,
                     geo.np, geo.pp, geo.heads, int(_aligned16(x, B, C)),
                     geo.smem)
    fn = _lib("ssd_scan", "repro_ssd_scan", [_i, ctypes.c_void_p, _vp])
    with torch.cuda.device(x.device):
        err = fn(_DTYPE_CODE[x.dtype], ctypes.addressof(prm), _stream(x))
    _raise_on("ssd_scan", err)
    launches["ssd_scan"] += 1
    return y, state

