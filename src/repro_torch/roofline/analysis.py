"""Three-term roofline analysis from a traced dry-run program.

  compute    = traced FLOPs / (peak FLOP/s per card)
  memory     = traced bytes / (HBM bandwidth per card)
  collective = bytes moved by all-gather / all-reduce / reduce-scatter /
               all-to-all, each mesh axis's bytes over that axis's
               bandwidth

The JAX package reads XLA's per-device `cost_analysis` and the collectives
of the post-SPMD HLO text. The port has no compiler in between: it runs the
step eagerly on meta DTensors over a fake process group (`launch.steps`),
and `TraceCounter` counts at the shard-local op calls that DTensor makes,
so every count is per device, replicated work included:

- FLOPs are what the tensor cores run: products, batched products,
  convolutions and fused attention (`torch.utils.flop_counter`'s formulas,
  2*m*n*k for a product) on the local shapes. Elementwise work is not
  counted; XLA counts it too, so XLA's number would be somewhat higher.
- Bytes are each local op's input and output bytes (views and bare
  allocations move nothing; an in-place output is counted once, as an
  input; ops on host (CPU) tensors are not the device's and are left
  out, so a trace does not depend on what earlier traces cached). The
  port is eager, so this is the unfused traffic it really moves, and on
  the traced path the kernels' plain versions move it.
- Collective bytes are the output bytes of each functional collective
  DTensor issues, by kind, and by the mesh axis of its group.

Hardware constants: NVIDIA H100 SXM 80GB (HBM3, 700 W), from the data
sheet: these terms are arithmetic on those constants, not timings.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM (data sheet)
PEAK_FLOPS = 989e12   # dense bf16 FLOP/s per card
HBM_BW = 3.35e12      # HBM3 bytes/s per card
NVLINK_BW = 450e9     # NVLink 4, bytes/s per direction: the in-node "model" axis
NET_BW = 50e9         # one 400 Gb/s NDR port per card: "data" and "pod"
AXIS_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_KIND = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
         ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"))


def _collective_kind(func) -> Optional[str]:
    name = str(func._overloadpacket)
    if "c10d_functional" not in name:
        return None
    for key, kind in _KIND:
        if key in name:
            return kind
    return None


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


_aten = torch.ops.aten
# ops that move no data: aliases, and allocations (counted as memory)
_NO_TRAFFIC = {_aten.detach, _aten._unsafe_view, _aten.alias}
_ALLOCATORS = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided}


class TraceCounter(TorchDispatchMode):
    """Entered around a step on DTensors, it lets DTensor take every op (it
    answers NotImplemented to a DTensor op) and counts the shard-local
    calls that DTensor then makes, leaving out the fake-tensor calls of
    its sharding propagation. group_axes maps a process group's name to
    its mesh axis. Live bytes: each op output counts from its creation
    until its Python object dies."""

    def __init__(self, group_axes: Optional[Dict[str, str]] = None):
        super().__init__()
        self.group_axes = dict(group_axes or {})
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
        self.coll_axis: Dict[str, int] = {}
        self.live = 0
        self.peak_live = 0
        self.n_ops = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if (any(issubclass(t, FakeTensor) for t in types)
                or any(isinstance(t, FakeTensor) for t in _tensors(out))):
            # DTensor's sharding propagation on global-shape fake tensors:
            # metadata only, no device runs it
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = _collective_kind(func)
        if kind is not None:
            n = sum(_nbytes(t) for t in _tensors(out))
            self.coll[kind] += n
            group = next((a for a in list(args) + list(kwargs.values())
                          if isinstance(a, str) and a in self.group_axes),
                         None)
            axis = self.group_axes.get(group, "data")
            self.coll_axis[axis] = self.coll_axis.get(axis, 0) + n
            return out
        if func.is_view or packet in _NO_TRAFFIC or "c10d" in str(packet):
            return out
        ins = [t for a in list(args) + list(kwargs.values())
               for t in _tensors(a)]
        if any(t.device.type == "cpu" for t in ins + list(_tensors(out))):
            # host-side work (DTensor's shard bookkeeping, host constants
            # copied once per process): not the device's
            return out
        allocates = packet in _ALLOCATORS
        if not allocates:
            self.bytes += sum(_nbytes(t) for t in ins)
        for t in _tensors(out):
            if any(t is i for i in ins):
                continue      # written in place: counted as an input
            n = _nbytes(t)
            if not allocates:
                self.bytes += n
            self.live += n
            self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(t, self._free, n)
        return out


@dataclasses.dataclass
class Roofline:
    name: str
    flops: float            # per device
    bytes_accessed: float   # per device
    coll_bytes: float       # per device
    coll_breakdown: Dict[str, int]
    n_devices: int
    model_flops: Optional[float] = None   # 6*N*D (global, useful work)
    bytes_per_device: Optional[float] = None  # peak memory (argument+temp)
    coll_axis: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        if not self.coll_axis:
            return self.coll_bytes / NET_BW
        return sum(b / AXIS_BW.get(ax, NET_BW)
                   for ax, b in self.coll_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if not self.model_flops:
            return None
        return self.model_flops / max(self.flops * self.n_devices, 1.0)

    def row(self) -> Dict:
        return {
            "name": self.name,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "traced_gflops_per_dev": self.flops / 1e9,
            "traced_gbytes_per_dev": self.bytes_accessed / 1e9,
            "coll_gbytes_per_dev": self.coll_bytes / 1e9,
            "coll_breakdown": {k: v for k, v in self.coll_breakdown.items() if v},
            "useful_flops_ratio": self.useful_flops_ratio,
            "mem_gb_per_dev": (self.bytes_per_device or 0) / 1e9,
        }


def analyze(name: str, program, n_devices: int,
            model_flops: Optional[float] = None) -> Roofline:
    """The roofline of a `launch.steps.TracedProgram`."""
    coll = dict(program.coll)
    return Roofline(
        name=name, flops=float(program.flops),
        bytes_accessed=float(program.bytes),
        coll_bytes=float(sum(coll.values())), coll_breakdown=coll,
        n_devices=n_devices, model_flops=model_flops,
        bytes_per_device=float(program.argument_bytes + program.temp_bytes),
        coll_axis=dict(program.coll_axis),
    )


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D for training, 2*N*D for inference forward (N = active params,
    D = tokens processed)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
