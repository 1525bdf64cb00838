#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) once on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py                  # every phase, as a release check
    python3 chip_smoke.py --only build,kernels,train --train-layers 2
    python3 chip_smoke.py --only build,kernels,serve --layers 2

Phases, one JSON line each, every line tagged with the GPU's name and power
limit (`nvidia-smi --query-gpu=name,power.limit`):

1. env: versions of Python, torch, CUDA, nvcc and the driver.
2. build: nvcc builds every kernel from `src/repro_torch/kernels/csrc/`
   into `build/repro_torch/` (seconds, and ptxas's register and spill
   report).
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in float32 and bfloat16. Attention at the llama3-8b serving shapes (H=32,
   KV=8, D=128, B=16, CL=1024, C=128) and at awkward shapes (D=64 and D=32,
   ragged lengths, a ring cache wrapped twice, offset 0, S not a multiple
   of 128, Dk != Dv), max abs error against 2e-5 (float32) or 2e-2
   (bfloat16), with `scaled_dot_product_attention` as the library call.
   The fused lm-head loss (forward, and the backward's `dh` and `dW`
   from one launch) against its vocab-blocked
   twin at granite-3-2b's head (N=4096 and the Preprocessor's N=8192,
   D=2048, V=49155), llama3-8b's head, a tied (V,D) head and awkward V, N
   and dw_chunks; values by max abs error (2e-5 / 2e-2), gradients by max
   abs error over the largest entry (1e-4 / 2e-2), with the unfused
   composite (logits, logsumexp, gather, entropy, autograd) as yardstick.
   Each row has the kernel's, the plain version's and the yardstick's
   times (CUDA events) and the card's bound.
4. serve: llama3-8b at full width and depth in bfloat16 with random weights
   from a seed. `GenerationEngine(n_slots=16, max_len=1024,
   prefill_chunk=128)` serves random prompts of 768-1000 tokens until at
   least 24 requests have finished, across an atomic update at step 50, an
   update streamed in 8 chunks from step 100 and a `recompute_kv` update at
   step 150. It checks the version stamps and behavior logprobs of every
   finished rollout and that each kernel was launched, then runs one decode
   step and one prefill chunk again through the plain attention versions
   and compares the logits.
5. train: granite-3-2b at full width and depth in bfloat16 with random
   weights from a seed, fused loss and remat. An engine (16 slots,
   max_len 512) serves prompts of 128-384 tokens until 16 rollouts finish
   (rewards in {0, 1} from a seed); the Preprocessor (kl_coef 0.05) takes
   them; `pack` makes batches A and B of 8 rollouts (4 x 1024 tokens); the
   Trainer (lr 1e-3, guard on) steps on A, B, B poisoned, A; the new
   weights go into the running engine, which decodes until 8 more
   rollouts finish. It checks the version, the guard, the metrics, the
   stamps after the swap and the launch counts, then compares one loss and
   gradient on A through the kernels with the same through the plain
   fused loss.

Then it prints the `{"kernels": [...]}` summary, the GPU's name and power
limit as nvidia-smi gives them, and, last, `{"ok": true, "device": {...}}`.
A failed check raises: the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.metadata
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("env", "build", "kernels", "serve", "train")
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# name: (source, the TPU kernel it replaces, the label of its main-path case)
KERNELS = {
    "flash_decode": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:78", "serve"),
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                          "src/repro/kernels/prefill_attention.py:103",
                          "serve"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:75", "serve"),
    "fused_logprob_fwd": ("src/repro_torch/kernels/csrc/fused_logprob.cu",
                          "src/repro/kernels/fused_logprob.py:256", "train"),
    "fused_logprob_bwd": ("src/repro_torch/kernels/csrc/fused_logprob.cu",
                          "src/repro/kernels/fused_logprob.py:284", "train"),
}
N_FINISHED = 24
UPDATE_STEPS = {"atomic": 50, "streamed": 100, "recompute_kv": 150}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1-2: env and build
# ---------------------------------------------------------------------------

def phase_env(gpu: str) -> None:
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = None
    emit({"phase": "env", "gpu": gpu, "python": sys.version.split()[0],
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nvcc": nvcc[-1], "driver": nvidia_smi("driver_version"),
          "triton": triton, "device_count": torch.cuda.device_count(),
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})


def _nvcc() -> str:
    from repro_torch.kernels import build
    return build.nvcc_path()


def phase_build(gpu: str) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build()
    report = {}
    for name in build.SOURCES:
        log = build.lib_path(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        report[name] = [ln.split("ptxas info    : ")[-1] for ln in lines
                        if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "gpu": gpu, "seconds": seconds,
          "wall_s": time.perf_counter() - t0, "ptxas": report})


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def _bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_case(B, H, KV, CL, D, lengths, dtype, seed):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(gen, (B, H, D), dtype)
    kc = _randn(gen, (B, CL, KV, D), dtype)
    vc = _randn(gen, (B, CL, KV, D), dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    mask = (torch.arange(CL, device="cuda")[None] < lens[:, None])[:, None, None]
    qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    n = float(np.minimum(lengths, CL).sum())
    elt = q.element_size()
    nbytes = (q.numel() + B * H * D + 2 * n * KV * D) * elt + 4 * B
    return dict(
        shape=dict(B=B, H=H, KV=KV, CL=CL, D=D, lengths=list(map(int, lengths))),
        kernel=lambda: ops.flash_decode(q, kc, vc, lens, scale=scale),
        plain=lambda: ref.flash_decode_ref(q, kc, vc, lens, scale=scale),
        library=lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True),
        bound=_bound(nbytes, 4.0 * n * H * D, dtype))


def prefill_case(B, C, H, KV, CL, Dk, Dv, off, dtype, seed):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(gen, (B, C, H, Dk), dtype)
    kh = _randn(gen, (B, C, KV, Dk), dtype)
    vh = _randn(gen, (B, C, KV, Dv), dtype)
    kc = _randn(gen, (B, CL, KV, Dk), dtype)
    vc = _randn(gen, (B, CL, KV, Dv), dtype)
    scale = Dk ** -0.5
    # the mask the kernel applies: ring rule on the cache, causal on the chunk
    j = torch.arange(CL, device="cuda")
    qp = off + torch.arange(C, device="cuda")
    p_j = (off - 1) - torch.remainder(off - 1 - j, CL)
    m_cache = (p_j[None] >= 0) & (qp[:, None] - p_j[None] < CL)
    m_chunk = torch.ones(C, C, dtype=torch.bool, device="cuda").tril()
    mask = torch.cat([m_cache, m_chunk], dim=1)
    # the library call takes the keys concatenated; the concatenation is
    # made here, outside its timing
    qs = q.transpose(1, 2)
    kcat = torch.cat([kc, kh], dim=1).transpose(1, 2)
    vcat = torch.cat([vc, vh], dim=1).transpose(1, 2)
    pairs = float(mask.sum())
    slots = float(m_cache.any(0).sum())
    elt = q.element_size()
    nbytes = (q.numel() + kh.numel() + vh.numel() + B * C * H * Dv
              + B * slots * KV * (Dk + Dv)) * elt
    return dict(
        shape=dict(B=B, C=C, H=H, KV=KV, CL=CL, Dk=Dk, Dv=Dv, offset=off),
        kernel=lambda: ops.prefill_attention(q, kh, vh, kc, vc, off,
                                             scale=scale),
        plain=lambda: ref.prefill_attention_ref(q, kh, vh, kc, vc, off,
                                                scale=scale),
        library=lambda: F.scaled_dot_product_attention(
            qs, kcat, vcat, attn_mask=mask, scale=scale, enable_gqa=True),
        bound=_bound(nbytes, 2.0 * B * H * pairs * (Dk + Dv), dtype))


def flash_case(B, H, KV, S, D, dtype, seed, window=0):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(gen, (B, H, S, D), dtype)
    k = _randn(gen, (B, KV, S, D), dtype)
    v = _randn(gen, (B, KV, S, D), dtype)
    scale = D ** -0.5
    i = torch.arange(S, device="cuda")
    mask = i[:, None] >= i[None]
    if window:
        mask &= (i[:, None] - i[None]) < window
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, scale=scale, enable_gqa=True)
    elt = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
    return dict(
        shape=dict(B=B, H=H, KV=KV, S=S, D=D, window=window),
        kernel=lambda: ops.flash_attention(q, k, v, scale=scale, window=window),
        plain=lambda: ref.flash_attention_ref(q, k, v, scale=scale,
                                              window=window),
        library=library,
        bound=_bound(nbytes, 4.0 * B * H * float(mask.sum()) * D, dtype))


def kernel_cases(dtype):
    """(kernel name, label, case builder) at the slice's shapes and at
    awkward ones. The `serve` label marks the shapes of the serving path."""
    rng = np.random.default_rng(0)
    serve_lengths = rng.integers(769, 1025, 16)   # prompts 768-1000, + decode
    return [
        ("flash_decode", "serve",
         lambda: decode_case(16, 32, 8, 1024, 128, serve_lengths, dtype, 1)),
        ("flash_decode", "d64-ragged",
         lambda: decode_case(3, 8, 2, 320, 64, [1, 77, 320], dtype, 2)),
        ("flash_decode", "d32-mha-full-ring",
         lambda: decode_case(2, 4, 4, 96, 32, [96, 5], dtype, 3)),
        ("flash_decode", "mqa",
         lambda: decode_case(2, 8, 1, 256, 128, [200, 256], dtype, 4)),
        ("prefill_attention", "serve",
         lambda: prefill_case(16, 128, 32, 8, 1024, 128, 128, 512, dtype, 5)),
        ("prefill_attention", "offset0-d64",
         lambda: prefill_case(2, 16, 8, 2, 128, 64, 64, 0, dtype, 6)),
        ("prefill_attention", "ring-wrapped-twice-d32",
         lambda: prefill_case(1, 8, 4, 4, 32, 32, 32, 72, dtype, 7)),
        ("prefill_attention", "ring-straddle-d64",
         lambda: prefill_case(2, 4, 8, 2, 32, 64, 64, 36, dtype, 8)),
        ("prefill_attention", "ragged-rows-mla-dk80-dv64",
         lambda: prefill_case(2, 12, 6, 1, 48, 80, 64, 40, dtype, 9)),
        ("flash_attention", "serve",
         lambda: flash_case(16, 32, 8, 1024, 128, dtype, 10)),
        ("flash_attention", "s200-d64",
         lambda: flash_case(2, 8, 2, 200, 64, dtype, 11)),
        ("flash_attention", "s77-d32-mha",
         lambda: flash_case(1, 4, 4, 77, 32, dtype, 12)),
        ("flash_attention", "s300-window64",
         lambda: flash_case(1, 4, 2, 300, 64, dtype, 13, window=64)),
    ]


# fused_logprob: value, dh and dW against the blocked twin. Gradients are
# held relative to the largest entry of the plain version's: the two sum
# the logits gradient over V in another order (f32), and in bfloat16 both
# round the same float32 sums once (a flipped last bit is 2^-8 relative).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FUSED = ("fused_logprob_fwd", "fused_logprob_bwd")
YARDSTICK = ("unfused composite: h @ W, then logsumexp, gather and entropy "
             "over the (N, V) logits (autograd backward for dh, dW)")


def fused_case(N, D, V, transpose, dtype, seed, dw_chunks=1, bwd=True):
    """Inputs and callables of one fused_logprob case: unit-normal hidden,
    head entries of std D^-1/2 (logits of order 1), uniform targets, normal
    cotangents for the three outputs."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = _randn(gen, (N, D), dtype)
    w = (torch.randn((V, D) if transpose else (D, V), generator=gen,
                     device="cuda") * D ** -0.5).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    g = torch.randn((3, N), generator=gen, device="cuda")
    elt = h.element_size()
    kw = dict(transpose_head=transpose)
    lp, lse, ent = ops.fused_logprob(h, w, t, **kw)
    c0, glp, gent = ref.logits_grad_coef(lse, ent, *g)
    rows = (h, w, t, lse, c0, glp, gent)
    plain_rows = (h, w, t, lse, ent, *g)
    flops = 2.0 * N * D * V
    in_bytes = (N * D + D * V) * elt + 4 * N

    def composite_fwd(h=h, w=w):
        logits = (h @ (w.T if transpose else w)).float()
        lse_ = torch.logsumexp(logits, -1)
        tl = logits.gather(1, t[:, None])[:, 0]
        ent_ = lse_ - (torch.softmax(logits, -1) * logits).sum(-1)
        return tl - lse_, lse_, ent_

    def composite_bwd():
        hh, ww = h.detach().requires_grad_(), w.detach().requires_grad_()
        out = composite_fwd(hh, ww)
        torch.autograd.backward(out, list(g))
        return hh.grad, ww.grad

    cases = {"fused_logprob_fwd": dict(
        kernel=lambda: ops.fused_logprob(h, w, t, **kw),
        plain=lambda: ref.fused_logprob_blocked(h, w, t, **kw),
        library=composite_fwd, tol=TOL[dtype], rel=False,
        bound=_bound(in_bytes + 12 * N, flops, dtype))}
    if bwd:
        # the logits recomputed once, then the dh and dW products: 3 x 2NDV
        cases["fused_logprob_bwd"] = dict(
            kernel=lambda: ops.fused_logprob_bwd(*rows, dw_chunks=dw_chunks,
                                                 **kw),
            plain=lambda: ref.blocked_backward(*plain_rows,
                                               dw_chunks=dw_chunks, **kw),
            library=composite_bwd, tol=GRAD_TOL[dtype], rel=True,
            bound=_bound(in_bytes + 16 * N + (N + V) * D * elt, 3 * flops,
                         dtype))
    shape = dict(N=N, D=D, V=V, head="(V,D)" if transpose else "(D,V)",
                 dw_chunks=dw_chunks)
    return shape, cases


def fused_cases():
    """(label, case builder args) for fused_logprob. `train` is the slice's
    shape: granite-3-2b's untied head at the train phase's batch of
    4 x 1024 tokens."""
    return [
        ("train", dict(N=4096, D=2048, V=49155, transpose=False)),
        ("preprocess", dict(N=8192, D=2048, V=49155, transpose=False,
                            bwd=False)),
        ("llama3-8b-head", dict(N=1024, D=4096, V=128256, transpose=False)),
        ("tied-VD", dict(N=512, D=256, V=1000, transpose=True)),
        ("v50", dict(N=16, D=64, V=50, transpose=False)),
        ("v33-tied", dict(N=24, D=32, V=33, transpose=True)),
        ("ragged-n300", dict(N=300, D=128, V=777, transpose=False)),
        ("dw-chunks4", dict(N=520, D=64, V=300, transpose=True, dw_chunks=4)),
    ]


def _max_err(out, exp) -> tuple:
    """(max abs error, the plain version's largest entry, the largest of
    each output's max abs error over its own plain version's largest entry,
    all finite) over the outputs of `out` against those of `exp`."""
    outs = out if isinstance(out, tuple) else (out,)
    exps = exp if isinstance(exp, tuple) else (exp,)
    errs = [float((o.float() - e.float()).abs().max())
            for o, e in zip(outs, exps)]
    scales = [float(e.float().abs().max()) for e in exps]
    rel = max(er / max(sc, 1e-30) for er, sc in zip(errs, scales))
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    return max(errs), max(scales), rel, finite


def phase_fused(gpu: str, dtypes) -> list:
    results, failures = [], []
    for dtype in dtypes:
        for seed, (label, args) in enumerate(fused_cases()):
            shape, cases = fused_case(dtype=dtype, seed=100 + seed, **args)
            big = shape["N"] * shape["V"] > 1e7
            for name, c in cases.items():
                err, scale, rel, finite = _max_err(c["kernel"](),
                                                   c["plain"]())
                torch.cuda.synchronize()
                rel = rel if c["rel"] else err
                ok = finite and rel <= c["tol"]
                iters = 3 if big else 5
                row = dict(name=name, label=label, shape=shape,
                           dtype=str(dtype).replace("torch.", ""),
                           max_err=err, ref_max_abs=scale,
                           err_measure="max_abs / ref_max_abs" if c["rel"]
                           else "max_abs", err_value=rel, tol=c["tol"], ok=ok,
                           kernel_ms=cuda_ms(c["kernel"], iters),
                           plain_ms=cuda_ms(c["plain"], 2),
                           library_ms=None,
                           yardstick_ms=cuda_ms(c["library"], 2),
                           yardstick=YARDSTICK,
                           bound_ms=c["bound"][0], bound_by=c["bound"][1])
                results.append(row)
                if not ok:
                    failures.append(f"{name}/{label}/{row['dtype']}: "
                                    f"{row['err_measure']} {rel}")
            del cases
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "fused_logprob", "gpu": gpu,
          "kernels": results})
    if failures:
        raise SystemExit("fused_logprob disagrees with its plain version: "
                         + "; ".join(failures))
    return results


def phase_kernels(gpu: str) -> list:
    results, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, make in kernel_cases(dtype):
            case = make()
            out = case["kernel"]()
            exp = case["plain"]()
            torch.cuda.synchronize()
            err = float((out.float() - exp.float()).abs().max())
            ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
            iters = 20 if label == "serve" else 5
            row = dict(name=name, label=label, shape=case["shape"],
                       dtype=str(dtype).replace("torch.", ""), max_err=err,
                       tol=TOL[dtype], ok=ok,
                       kernel_ms=cuda_ms(case["kernel"], iters),
                       plain_ms=cuda_ms(case["plain"], max(iters // 4, 2)),
                       library_ms=cuda_ms(case["library"], iters),
                       bound_ms=case["bound"][0], bound_by=case["bound"][1])
            results.append(row)
            if not ok:
                failures.append(f"{name}/{label}/{row['dtype']}: err {err}")
            del case, out, exp
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "gpu": gpu, "kernels": results})
    if failures:
        raise SystemExit("kernel disagrees with its plain version: "
                         + "; ".join(failures))
    return results


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain PyTorch versions, on
    the card, for one comparison."""
    from repro_torch.kernels import ops, ref
    saved = (ops.flash_decode, ops.prefill_attention, ops.flash_attention)
    ops.flash_decode = ref.flash_decode_ref
    ops.prefill_attention = ref.prefill_attention_ref
    ops.flash_attention = ref.flash_attention_ref
    try:
        yield
    finally:
        ops.flash_decode, ops.prefill_attention, ops.flash_attention = saved


def _logits_err(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Kernel-path logits `a` against plain-path logits `b`. Both paths
    round every attention output to bfloat16 and sum in float32 in another
    order, so single elements flip by an ulp; over 32 layers the flips add
    up to a few percent of a logit. The check holds the relative RMS
    difference to 5e-2: a wrong mask or head mapping moves the logits by
    the order of the logits themselves. (Each kernel alone is held to 2e-2
    in the kernel phase.)"""
    a, b = a.float(), b.float()
    diff = a - b
    rel_rms = float(diff.norm() / b.norm())
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    return {"max_err": float(diff.abs().max()),
            "mean_err": float(diff.abs().mean()),
            "max_abs_logit": float(b.abs().max()), "rel_rms": rel_rms,
            "top1_agree": top1, "tol_rel_rms": 5e-2, "ok": rel_rms <= 5e-2}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile(fn, dev, top: int = 8) -> dict:
    """One call of `fn` under torch.profiler (CUPTI): wall time, the summed
    device time of its kernels, their share of the wall time (one stream,
    so kernels do not overlap; the profiler's own host cost is inside the
    wall time) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    busy_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if busy_ms else None,
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for ms, k, n in sorted(rows, reverse=True)[:top]]}


def phase_serve(gpu: str, n_layers: int, device="cuda") -> dict:
    """The serving path on `device` (the card; a CPU run rehearses the
    phase's logic at a reduced config and measures nothing)."""
    import dataclasses

    from repro_torch import EngineConfig, GenerationEngine, get_config
    from repro_torch.core import weights as W
    from repro_torch.data.math_task import Problem
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("llama3-8b")
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device)
    ec = EngineConfig(n_slots=16, max_len=1024, prefill_chunk=128,
                      temperature=1.0)
    rng = np.random.default_rng(0)

    def source():
        n = int(rng.integers(768, 1001))
        return Problem(rng.integers(3, cfg.vocab_size, n).tolist(), 0)

    eng = GenerationEngine(cfg, M.init_params(cfg, seed=0, device=dev), ec,
                           source, seed=0, device=dev)
    ops.reset_launches()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    finished, step_s, chunk_ms = [], [], []
    ttft_s = recompute_ms = None
    sampled = 0
    t_start = time.perf_counter()
    step = 0
    while len(finished) < N_FINISHED or step <= UPDATE_STEPS["recompute_kv"]:
        if step == UPDATE_STEPS["atomic"]:
            eng.set_weights(M.init_params(cfg, seed=1, device=dev), version=1)
        if step == UPDATE_STEPS["streamed"]:
            new = M.init_params(cfg, seed=2, device=dev)
            leaves = W.tree_flatten(new)[0]
            sizes = W.span_bytes(leaves, W.chunk_spans(leaves, 8))
            tokens = [W.chunk_token(2, k, s) for k, s in enumerate(sizes)]
            got = eng.begin_weight_stream(
                new, version=2, n_chunks=8,
                expect_digest=W.stream_digest(tokens))
            assert got == sizes, (got, sizes)
            del new
            k_next = 0
        if eng.stream_active:       # one chunk between two decode steps
            eng.stream_weight_chunk(token=tokens[k_next])
            k_next += 1
        if step == UPDATE_STEPS["recompute_kv"]:
            new = M.init_params(cfg, seed=3, device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            eng.set_weights(new, version=3, recompute_kv=True)
            _sync(dev)
            recompute_ms = (time.perf_counter() - t0) * 1e3
            del new
        n_inv = eng.prefill_invocations
        t0 = time.perf_counter()
        eng.refill(now=float(step))
        _sync(dev)
        if eng.prefill_invocations > n_inv:
            chunk_ms.append((time.perf_counter() - t0) * 1e3
                            / (eng.prefill_invocations - n_inv))
        n_tok = eng.tokens_generated
        t0 = time.perf_counter()
        done = eng.step(now=float(step))
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        sampled += eng.tokens_generated - n_tok
        if ttft_s is None:
            ttft_s = time.perf_counter() - t_start
        finished.extend(done)
        step += 1
        if step > 2000:
            raise SystemExit(f"serve: only {len(finished)} finished "
                             f"after {step} steps")
    launches = dict(ops.launches)
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 2**30
               if dev.type == "cuda" else None)

    # --- checks on what came out
    bad = []
    versions = set()
    for r in finished:
        wv, pl = r.weight_versions, r.prompt_len
        if (wv[:pl] != 0).any() or (np.diff(wv) < 0).any():
            bad.append(f"slot {r.slot}: version stamps {wv[pl - 1:].tolist()}")
        lp = r.behavior_logprobs[pl:]
        if not np.isfinite(lp).all() or (lp > 0).any():
            bad.append(f"slot {r.slot}: behavior logprobs not finite/<=0")
        if (r.tokens < 0).any() or (r.tokens >= cfg.vocab_size).any():
            bad.append(f"slot {r.slot}: token out of range")
        versions.update(int(x) for x in wv[pl:])
    if eng.version != 3 or eng.wstreams_torn or eng.wchunks_rejected:
        bad.append(f"engine version {eng.version}, torn {eng.wstreams_torn}, "
                   f"rejected {eng.wchunks_rejected}")
    for name in KERNELS:
        if name not in FUSED and launches[name] <= 0:
            bad.append(f"{name} was never launched on the serving path")

    # --- one decode step and one prefill chunk again through the plain
    # attention versions, on copies of the same state
    st = eng.state
    idx = torch.arange(ec.n_slots, device=dev)
    cur = st["tokens"][idx, st["n_cached"]][:, None]
    pos = st["n_cached"][:, None]

    def decode_logits():
        cache = {k: v.clone() for k, v in st["cache"].items()}
        return M.decode_step(eng.params, cur, pos, cache, st["n_cached"],
                             cfg, ring=False)["logits"]

    def prefill_logits():
        cache = {k: v.clone() for k, v in st["cache"].items()}
        admit = torch.ones(ec.n_slots, dtype=torch.bool, device=dev)
        return M.prefill_chunk(eng.params, st["tokens"], st["prompt_len"],
                               512, admit, cache, cfg, chunk=128,
                               logits=True)["logits"]

    dec_k = decode_logits()
    with plain_attention():
        dec_p = decode_logits()
    check_decode = _logits_err(dec_k, dec_p)
    del dec_k, dec_p
    pre_k = prefill_logits()
    with plain_attention():
        pre_p = prefill_logits()
    check_prefill = _logits_err(pre_k, pre_p)
    del pre_k, pre_p
    for nm, chk in (("decode", check_decode), ("prefill", check_prefill)):
        if not chk["ok"]:
            bad.append(f"{nm} logits: kernel vs plain {chk}")

    profile = syncs = None
    if dev.type == "cuda":
        # device-to-host syncs of one decode step: the `finished` mask only,
        # plus the finished rows' tokens when a rollout ends
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            n_done = len(eng.step())
        torch.cuda.set_sync_debug_mode(0)
        n_sync = sum("synchroniz" in str(w.message).lower() for w in caught)
        syncs = {"decode_step": n_sync, "rollouts_finished": n_done}
        if n_done == 0 and n_sync > 1:
            bad.append(f"a decode step synced {n_sync} times")
        cache = {k: v.clone() for k, v in st["cache"].items()}
        admit = torch.zeros(ec.n_slots, dtype=torch.bool, device=dev)
        profile = {
            "decode_step": _profile(lambda: eng.step(), dev),
            "prefill_chunk": _profile(lambda: M.prefill_chunk(
                eng.params, st["tokens"], st["prompt_len"], 512, admit,
                cache, cfg, chunk=128), dev)}
        del cache

    steady = step_s[1:]
    res = {"phase": "serve", "gpu": gpu, "config": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "d_head": cfg.d_head,
           "vocab": cfg.vocab_size, "dtype": str(cfg.dtype).replace("torch.", ""),
           "engine": dataclasses.asdict(ec), "steps": step,
           "finished": len(finished),
           "finished_versions": sorted(versions),
           "prefill_invocations": eng.prefill_invocations,
           "decode_tokens_per_s": sampled / sum(step_s),
           "decode_step_ms_median": statistics.median(steady) * 1e3,
           "prefill_chunk_ms_median": statistics.median(chunk_ms),
           "ttft_ms": ttft_s * 1e3, "recompute_kv_ms": recompute_ms,
           "peak_mem_gib": peak_gb, "launches": launches,
           "logits_decode": check_decode, "logits_prefill": check_prefill,
           "syncs": syncs, "profile": profile, "failures": bad}
    emit(res)
    if bad:
        raise SystemExit("serve phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# phase 5: the training path
# ---------------------------------------------------------------------------

TRAIN_ROLLOUTS = 16       # served, preprocessed and packed into A and B
TRAIN_AFTER_SWAP = 8      # rollouts finished after the weights are published
# kernel path against plain path, one loss and gradient on batch A: the
# fused loss's per-token values agree to ~1e-6 (kernel phase), so the loss
# agrees to about that; the gradients flow back through 40 bf16 layers from
# dh values that round to bf16 in both paths with occasional one-ulp flips
TRAIN_TOL = {"loss_rel": 1e-3, "grad_norm_rel": 1e-2, "leaf_rel_rms": 5e-2}


@contextlib.contextmanager
def plain_fused_loss():
    """Route the model's fused loss through its plain version (the blocked
    twin), on the card, for one comparison."""
    from repro_torch.kernels import ops, ref
    saved = ops.fused_logprob
    ops.fused_logprob = ref.fused_logprob_blocked
    try:
        yield
    finally:
        ops.fused_logprob = saved


def _serve_until(eng, n, task_reward, finished, now):
    """Step (refilling) `eng` until `n` more rollouts finish; each gets a
    reward from `task_reward`. Returns the steps taken."""
    steps, target = 0, len(finished) + n
    while len(finished) < target:
        eng.refill(now=now + steps)
        for r in eng.step(now=now + steps):
            r.reward = task_reward()
            finished.append(r)
        steps += 1
        if steps > 4000:
            raise SystemExit(f"train: only {len(finished)} rollouts finished")
    return steps


def _grads_of(params, batch, cfg, rl, dev):
    """Loss, metrics and gradients of one `loss_fn` on `batch`, with the
    forward and backward timed apart."""
    from repro_torch.core.trainer import loss_fn
    from repro_torch.core.weights import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    _sync(dev)
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(treedef, live), batch, cfg, rl)
        _sync(dev)
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, live)
    _sync(dev)
    t2 = time.perf_counter()
    return (float(loss.detach()), list(grads), (t1 - t0) * 1e3,
            (t2 - t1) * 1e3)


def phase_train(gpu: str, n_layers: int, device="cuda") -> dict:
    """The training path on `device` (the card; a CPU run rehearses the
    phase's logic at a reduced config and measures nothing): serve
    rollouts, preprocess, pack, four trainer steps (one poisoned), publish
    the new weights into the running engine."""
    import dataclasses

    from repro_torch import (AdamConfig, EngineConfig, GenerationEngine,
                             PreprocessConfig, Preprocessor, RLConfig,
                             Trainer, get_config, pack)
    from repro_torch.core.weights import tree_flatten
    from repro_torch.data.math_task import Problem
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim.adam import global_norm

    cfg = dataclasses.replace(get_config("granite-3-2b"), fused_loss=True,
                              remat=True)
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device)
    ec = EngineConfig(n_slots=16, max_len=512, prefill_chunk=128,
                      temperature=1.0)
    rng = np.random.default_rng(0)
    reward_rng = np.random.default_rng(0)

    def source():
        n = int(rng.integers(128, 385))
        return Problem(rng.integers(3, cfg.vocab_size, n).tolist(), 0)

    def reward():
        return float(reward_rng.integers(0, 2))

    params = M.init_params(cfg, seed=0, device=dev)
    eng = GenerationEngine(cfg, params, ec, source, seed=0, device=dev)
    # the frozen initial policy is pi_ref; nothing writes into it
    pre = Preprocessor(cfg, params, PreprocessConfig(kl_coef=0.05,
                                                     max_len=ec.max_len),
                       device=dev)
    trainer = Trainer(cfg, params, rl=RLConfig(), adam=AdamConfig(lr=1e-3),
                      guard=True, device=dev)
    ops.reset_launches()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # 1. serve until 16 rollouts finish
    rollouts: list = []
    t0 = time.perf_counter()
    serve_steps = _serve_until(eng, TRAIN_ROLLOUTS, reward, rollouts, 0.0)
    _sync(dev)
    serve_s = time.perf_counter() - t0
    rollouts = rollouts[:TRAIN_ROLLOUTS]

    # 2. reference logprobs and KL-shaped rewards
    t0 = time.perf_counter()
    pre.process(rollouts)
    _sync(dev)
    pre_ms = (time.perf_counter() - t0) * 1e3
    pre_calls = 1
    bucket = pre._bucket(max(r.length for r in rollouts), ec.max_len)

    # 3. pack A and B
    half = TRAIN_ROLLOUTS // 2
    A = pack(rollouts[:half], batch=4, seq=1024,
             trainer_version=trainer.version)
    B = pack(rollouts[half:], batch=4, seq=1024,
             trainer_version=trainer.version)

    # 4. four steps: A, B, B poisoned, A
    bad = []
    step_ms, metrics, verdicts = [], [], []
    kept = None
    for i, (batch, poison) in enumerate(((A, False), (B, False), (B, True),
                                         (A, False))):
        if poison:
            kept = list(tree_flatten(trainer.state)[0])
        _sync(dev)
        t0 = time.perf_counter()
        m = trainer.step(batch, poison=poison)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        verdicts.append(trainer.last_nonfinite())
        metrics.append(dict(m))
        if poison:
            same = all(torch.equal(a, b) for a, b in
                       zip(kept, tree_flatten(trainer.state)[0]))
            if not same:
                bad.append("the poisoned step changed the train state")
            kept = None
    version = trainer.version

    # 5. publish into the running engine, decode on
    in_flight = eng.n_active
    eng.set_weights(trainer.params, version)
    after: list = []
    t0 = time.perf_counter()
    after_steps = _serve_until(eng, TRAIN_AFTER_SWAP, reward, after, 1e4)
    _sync(dev)
    after_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 2**30
               if dev.type == "cuda" else None)

    # --- checks on what came out
    nonfinite = [m["nonfinite"] for m in metrics]
    if version != 3 or nonfinite != [0.0, 0.0, 1.0, 0.0] \
            or verdicts != [False, False, True, False]:
        bad.append(f"version {version}, nonfinite {nonfinite}, "
                   f"verdicts {verdicts}")
    for i, m in enumerate(metrics):
        if i == 2:
            continue
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            bad.append(f"step {i + 1}: loss {m['loss']}, grad_norm "
                       f"{m['grad_norm']}")
    mask_a = A["loss_mask"]
    beh_a = float((A["behavior_logprobs"] * mask_a).sum() / mask_a.sum())
    mean_lp = [beh_a - metrics[0]["token_kl"], beh_a - metrics[3]["token_kl"]]
    if not mean_lp[0] != mean_lp[1]:
        bad.append(f"batch A's mean token logprob did not move: {mean_lp}")
    post = []
    for r in after:
        wv, pl = r.weight_versions, r.prompt_len
        if (np.diff(wv) < 0).any() or (wv[:pl] != 0).any() \
                or not set(wv[pl:].tolist()) <= {0, 3} or wv[-1] != 3:
            bad.append(f"slot {r.slot}: stamps after the swap "
                       f"{sorted(set(wv[pl:].tolist()))}, last {wv[-1]}")
        post.append(int((wv == 3).sum()))
    want = {"fused_logprob_fwd": 4 + pre_calls, "fused_logprob_bwd": 4,
            "flash_attention": cfg.n_layers * pre_calls}
    for name, n in want.items():
        if launches[name] != n:
            bad.append(f"{name}: {launches[name]} launches, expected {n}")
    for name in ("flash_decode", "prefill_attention"):
        if launches[name] <= 0:
            bad.append(f"{name} was never launched by the engine")

    # --- one loss and gradient on batch A, kernel path against plain path
    staged = trainer._stage({k: v for k, v in A.items()
                             if k not in ("packing_stats", "weight_versions",
                                          "lag", "truncated")})
    lk, gk, fwd_ms, bwd_ms = _grads_of(trainer.params, staged, cfg,
                                       trainer.rl, dev)
    with plain_fused_loss():
        lp_, gp, _, _ = _grads_of(trainer.params, staged, cfg, trainer.rl,
                                  dev)
    nk, np_ = float(global_norm(gk)), float(global_norm(gp))
    leaf_rms = [float((a.float() - b.float()).norm()
                      / b.float().norm().clamp_min(1e-30))
                for a, b in zip(gk, gp)]
    check = {"loss": [lk, lp_], "grad_norm": [nk, np_],
             "loss_rel": abs(lk - lp_) / max(abs(lp_), 1e-30),
             "grad_norm_rel": abs(nk - np_) / max(np_, 1e-30),
             "leaf_rel_rms_max": max(leaf_rms), "tol": TRAIN_TOL}
    check["ok"] = (check["loss_rel"] <= TRAIN_TOL["loss_rel"]
                   and check["grad_norm_rel"] <= TRAIN_TOL["grad_norm_rel"]
                   and check["leaf_rel_rms_max"] <= TRAIN_TOL["leaf_rel_rms"])
    if not check["ok"]:
        bad.append(f"kernel path against plain path: {check}")
    del gk, gp
    # one more step on A under the profiler: the device's share of a step
    # and the kernels that take it (after every check and count)
    profile = (_profile(lambda: trainer.step(A), dev, top=16)
               if dev.type == "cuda" else None)

    # trained tokens: the batch's rollout tokens (segment id > 0), pad
    # slots left out; the loss reads the completion tokens among them
    real = [int((bt["segment_ids"] > 0).sum()) for bt in (A, B)]
    completion = [float(bt["loss_mask"].sum()) for bt in (A, B)]
    # the first step pays one-time costs (cuBLAS handles, the allocator's
    # first segments): the median is over the steps after it. The rate is
    # over the healthy steps after it, 2 (B) and 4 (A); the poisoned step 3
    # trains nothing
    median_ms = statistics.median(step_ms[1:])
    rate_s = (step_ms[1] + step_ms[3]) / 1e3
    res = {"phase": "train", "gpu": gpu, "config": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "fused_loss": cfg.fused_loss, "remat": cfg.remat,
           "engine": dataclasses.asdict(ec), "serve_steps": serve_steps,
           "serve_s": serve_s, "rollout_lengths": [r.length for r in rollouts],
           "preprocess_bucket": bucket, "preprocess_ms_per_batch": pre_ms,
           "packed_slots": int(A["tokens"].size), "trained_tokens": real,
           "completion_tokens": completion,
           "fill": [A["packing_stats"]["fill"], B["packing_stats"]["fill"]],
           "step_ms": step_ms, "step_ms_median": median_ms,
           "forward_ms": fwd_ms, "backward_ms": bwd_ms,
           "trained_tokens_per_s": (real[1] + real[0]) / rate_s,
           "completion_tokens_per_s": (completion[1] + completion[0])
           / rate_s,
           "metrics": metrics, "mean_token_logprob_A": mean_lp,
           "version": version, "in_flight_at_swap": in_flight,
           "after_swap_steps": after_steps, "after_swap_s": after_s,
           "after_swap_v3_tokens": post, "peak_mem_gib": peak_gb,
           "launches": launches, "expected_launches": want,
           "kernel_vs_plain": check, "profile": profile, "failures": bad}
    emit(res)
    if bad:
        raise SystemExit("train phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------

def summary(kernels: list, serve, train, gpu: str) -> list:
    """One entry per kernel: its case at the main path's shapes in bfloat16
    and its launches on the path that runs it (the serve phase for the
    attention kernels, the train phase for the fused loss)."""
    out = []
    for name, (source, replaces, main_label) in KERNELS.items():
        rows = [r for r in kernels if r["name"] == name]
        main_row = next((r for r in rows if r["label"] == main_label
                         and r["dtype"] == "bfloat16"), None)
        by_phase = {ph: res["launches"][name]
                    for ph, res in (("serve", serve), ("train", train)) if res}
        home = "train" if name in FUSED else "serve"
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": by_phase.get(home),
                 "launches_by_phase": by_phase, "gpu": gpu}
        if main_row is not None:
            entry.update(
                max_abs_err=main_row["max_err"], ms=main_row["kernel_ms"],
                plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"],
                bound_by=main_row["bound_by"],
                library_ms=main_row["library_ms"], shape=main_row["shape"],
                dtype=main_row["dtype"], tol=main_row["tol"])
            if "yardstick_ms" in main_row:
                entry.update(yardstick_ms=main_row["yardstick_ms"],
                             yardstick=main_row["yardstick"])
        entry["cases"] = [{k: r[k] for k in ("label", "dtype", "max_err",
                                             "err_measure", "err_value",
                                             "tol", "ok") if k in r}
                          for r in rows]
        out.append(entry)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run")
    ap.add_argument("--layers", type=int, default=32,
                    help="llama3-8b depth in the serve phase")
    ap.add_argument("--train-layers", type=int, default=40,
                    help="granite-3-2b depth in the train phase")
    args = ap.parse_args(argv)
    phases = [p for p in args.only.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    gpu = nvidia_smi("name,power.limit")
    kernels, serve, train = [], None, None
    if "env" in phases:
        phase_env(gpu)
    if "build" in phases:
        phase_build(gpu)
    if "kernels" in phases:
        kernels = phase_kernels(gpu)
        kernels += phase_fused(gpu, (torch.float32, torch.bfloat16))
    if "serve" in phases:
        serve = phase_serve(gpu, args.layers)
        torch.cuda.empty_cache()
    if "train" in phases:
        train = phase_train(gpu, args.train_layers)

    emit({"kernels": summary(kernels, serve, train, gpu)})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
