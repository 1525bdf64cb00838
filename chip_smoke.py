#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) once on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py                  # every phase, as a release check
    python3 chip_smoke.py --only build,kernels,ssm
    python3 chip_smoke.py --only build,kernels,hybrid,moe
    python3 chip_smoke.py --only build,kernels,server,faults
    python3 chip_smoke.py --only env,build,kernels,mla
    python3 chip_smoke.py --only build,kernels,pipeline
    python3 chip_smoke.py --only build,kernels,train --train-layers 2
    python3 chip_smoke.py --only build,kernels,serve --layers 2
    python3 chip_smoke.py --only env,build,sharded,launch,dryrun
    python3 chip_smoke.py --only env,build,mesh

Phases, one JSON line each, every line tagged with the GPU's name and power
limit (`nvidia-smi --query-gpu=name,power.limit`):

1. env: versions of Python, torch, CUDA, nvcc and the driver.
2. build: nvcc builds every kernel from `src/repro_torch/kernels/csrc/`
   into `build/repro_torch/` (seconds, and ptxas's register and spill
   report, with any wgmma serialisation it warns of).
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in float32 and bfloat16. Attention at the llama3-8b serving shapes (H=32,
   KV=8, D=128, B=16, CL=1024, C=128) and at awkward shapes (D=64 and D=32,
   ragged lengths, a ring cache wrapped twice, offset 0, S not a multiple
   of 128, Dk != Dv), max abs error against 2e-5 (float32) or 2e-2
   (bfloat16), with `scaled_dot_product_attention` as the library call;
   also at granite-3-2b's shapes: `prefill_attention` at the pipeline
   phase's admission chunk (B=16, C=64, CL=512, D=64, offset 320) and
   `flash_attention` at the dense Preprocessor's forward (B=16, S=512,
   D=64). Each row names the kernel its dtype took (`route`): bfloat16
   prefill/flash attention and the fused loss on the tensor cores
   ("wgmma"), float32 and the other kernels on the CUDA cores
   ("cuda-core").
   The paged decode at the pipeline phase's shapes (granite-3-2b heads,
   CL 512, page 64) and at llama3-8b's (B=16, CL=1024, lengths 773-1017,
   pages of 16 and 64) on a shuffled block table over a pool larger than
   the rows need, unallocated blocks on the trash page and two rows
   sharing pages; also held bit for bit against `flash_decode` on the same
   state gathered into the slot layout, with an index_select gather then
   `scaled_dot_product_attention` as the composite yardstick. Both decode
   kernels also at lengths on the edges of their splits (span - 1, span,
   span + 1 and a full cache, at pages 16 and 64), at hymba-1.5b's heads
   (25/5, d_head 64), at phi3-mini's (32/32, d_head 96), `flash_decode` at
   qwen3-32b's (64/8, d_head 128, CL 1024) and at the moe phase's decode
   (granite-moe-1b-a400m's 16/8, d_head 64, CL 512). `prefill_attention`
   and `flash_attention` also at the hybrid phase's admission chunk (16, C
   64, 25/5 heads, CL 512, offset 320) and Preprocessor forward (16, S 512),
   at the moe phase's (the same with 16/8 heads) and at phi3-mini's MHA
   d_head 96 (1.5 tensor-core panels). `prefill_attention` also at absorbed
   MLA's geometry at deepseek-v3's widths (one KV head, Dk 512 + 64, Dv
   512, 128 heads; the kernel's wide instance): the mla phase's admission
   chunk (16, C 64, CL 512, offset 320) and a cache of 1024 at offset 512,
   and off that shape (a ragged block of rows on a wrapped ring; Dk 320 /
   Dv 272, whose panels past the head dims the instance zeroes);
   where `scaled_dot_product_attention` refuses a shape, the row carries
   its error (`library_error`) and no library time.
   The fused lm-head loss (forward, and the backward's `dh` and `dW`
   from one launch) against its vocab-blocked
   twin at granite-3-2b's head (N=4096 and the Preprocessor's N=8192,
   D=2048, V=49155), llama3-8b's head, mamba2-2.7b's (N=4096, D=2560,
   V=50280), hymba-1.5b's (N=4096, D=1600, V=32001) and
   granite-moe-1b-a400m's (N=4096, D=1024, V=49155), both again at their
   Preprocessors' N=8192 (forward only), deepseek-v3's (N=4096, D=7168,
   V=129280), a tied (V,D) head and awkward V, N and dw_chunks; values by
   max abs error (2e-5 / 2e-2), gradients by max abs error over the
   largest entry (1e-4 / 2e-2), with the unfused composite (logits,
   logsumexp, gather, entropy, autograd) as yardstick. In bfloat16 every
   case runs the tensor-core kernels, the heads whose rows TMA cannot
   describe (V 49155, 50, 777) through the wrapper's aligned staging copy,
   which the kernel time includes.
   The SSD scan (`ssd_scan`, y and the final state) against the plain
   chunked SSD at mamba2-2.7b's Preprocessor call (16 x 512 tokens, 80
   heads of 64, state 128, chunk 64, x/B/C as strided views of one
   tensor) and train shape (4 x 1024), at awkward shapes (2 and 3
   groups, P 32 and 16, N 16 and 8, chunks of 16 and 32, one chunk), at
   hymba-1.5b's Preprocessor call (16 x 512, 50 heads of 64, state 16)
   and at the widths the kernel's layout reaches beyond those (N 256, P
   128 and 256, a chunk of 128 walked in halves, x/B/C at strides and
   data not 16-byte aligned), |err| <= atol + rtol |plain| with (1e-4,
   1e-3) in float32 and (5e-2, 5e-2) in bfloat16; bfloat16 on the tensor
   cores ("mma"), float32 on the CUDA cores; a differentiated call must
   raise. No PyTorch call computes the scan, so it has no library time.
   Each row has the kernel's, the plain version's and the yardstick's
   times (CUDA events), the card's bound and the bound's share of the
   kernel's time (`bound_share`).
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
6. pipeline: this slice's path, `PipelineRL` on one paged engine at
   granite-3-2b's full width and depth in bfloat16 (fused loss, remat,
   random weights from seed 0): `EngineConfig(n_slots=16, max_len=512,
   prefill_chunk=64, cache="paged", page_size=64, paged_attention=
   "kernel", prefix_sharing=True)`, the Preprocessor (kl_coef 0.05), the
   Trainer (lr 1e-3), a streamed broadcast in 8 chunks and the group
   baseline, for 3 optimizer steps. Prompts of 256-384 random token ids
   come in GRPO groups: each is yielded 8 times in a row. It checks the
   steps, the streamed swaps, the stamps, that every refill forked its
   identical prompts (7 forks per prefill for whole groups), the block
   tables, that `reset_slots` returns every page, the launches and the
   losses; then it runs 16 prompts for 32 decode steps through a paged
   engine (the paged kernel) and a slot engine and holds them bit for bit.
7. ssm: the path of `ssd_scan`, `PipelineRL` on mamba2-2.7b at full width
   and depth (`--ssm-layers`, default 64) in bfloat16 (fused loss, remat,
   random weights from seed 0): `EngineConfig(n_slots=16, max_len=512,
   prefill_chunk=64)` serving prompts of 256-384 random ids in plain
   PyTorch, the Preprocessor (kl_coef 0.05) whose forward runs the scan
   kernel in every layer, the Trainer (lr 1e-3, 4 x 1024 packing)
   differentiating the plain chunked SSD, a broadcast streamed in 8
   chunks, batch 16, 3 optimizer steps. It checks the steps, the swap and
   the stamps, finite behavior logprobs, the launches (`ssd_scan` = layers
   x Preprocessor calls, no attention kernel), and the Preprocessor's
   reference logprobs on one batch through the kernel against the plain
   scan (the RMS error over the RMS of the plain logprobs about each
   row's mean <= 5e-2 after 64 bf16 layers); one such
   Preprocessor call runs under the profiler, which reports the device
   ms of its 64 `ssd_scan` launches (`preprocess_profile`).
8. hybrid: hymba-1.5b at full width and depth (`--hybrid-layers`, default
   32; d 1600, 25/5 heads of 64, 50 SSM heads of 64, state 16, vocab
   32001) in bfloat16 (fused loss, remat, random weights from seed 0):
   `PipelineRL` on one paged engine as in pipeline (16 slots, max_len 512,
   chunk 64, page 64, the paged kernel, prefix sharing over GRPO groups of
   8, the group baseline), the Preprocessor (kl_coef 0.05) through
   `flash_attention`, `ssd_scan` and the fused forward, the Trainer (lr
   1e-3, 4 x 1024 packing), a broadcast streamed in 8 chunks, batch 16, 3
   optimizer steps. It checks the steps, the swap, the stamps, finite
   behavior logprobs, that the forks happened, the exact launches of every
   kernel but `flash_decode`, the block tables, the Preprocessor's
   reference logprobs through the kernels against the plain versions
   (as in ssm), with planted faults as its controls (`flash_attention`
   with a fifth of its heads zeroed in every layer, and in layer 0 alone,
   must fail it; the scan's in every layer is read); then 16 prompts in two groups of 8 run 32
   decode steps through a paged engine that forks them (the leader's conv
   and SSD rows copied into its forks) and a slot engine, bit for bit.
   One decode step, one prefill chunk and one Preprocessor call run under
   the profiler.
9. moe: granite-moe-1b-a400m at full width and depth (`--moe-layers`,
   default 24; d 1024, 16/8 heads, 32 experts top 8 of d_ff 512, vocab
   49155) in bfloat16 (fused loss, remat): `PipelineRL` on one slot engine
   (16 slots, max_len 512, chunk 64), batch 16, 3 steps, 4 x 1024 packing,
   a streamed broadcast. It checks what the hybrid phase checks that a
   slot engine has, a finite positive `moe_aux` in every step's metrics,
   and the Preprocessor against the plain versions with the attention
   faults as controls; one decode step runs
   under the profiler with each MoE layer marked, which gives the MoE
   layers' share of its device time.
10. mla: deepseek-v3-671b at its published widths (d 7168, 128 heads,
   q_lora 1536, kv_lora 512, nope 128, rope 64, v 128; 256 routed experts
   top 8 and a shared one of d_ff 2048, dense d_ff 18432, vocab 129280,
   the MTP head, capacity factor 2) in bfloat16 with the fused loss and
   random weights from seeds 0 and 1, its depth cut from 61 layers (3
   dense) to `--mla-layers` (default 2: one dense, one MoE; the cut is
   printed). A paged engine (16 slots, max_len 512, chunk 64, page 64,
   prefix sharing) serves prompts of 256-384 random ids in GRPO groups of
   8 until 16 rollouts finish, taking a swap streamed in 8 chunks from
   decode step 32 and a `recompute_kv` update at step 64; the Preprocessor
   (kl_coef 0.05) scores them in calls of 8 x 512 tokens (main and MTP
   stats through the fused forward). It checks the versions, the stamps,
   finite logprobs, the forks and the exact launches (`prefill_attention`
   = layers x chunks, the fused forward twice per Preprocessor call, no
   other kernel); then the kernel path against the plain one by the
   centered RMS measure on a prefill chunk's logits (with q_rope zeroed in
   every layer's call as the control, which must fail it), the
   Preprocessor's logprobs and the MTP logprobs (with a finite `moe_aux`);
   then paged against slots bit for bit over 32 decode steps with two
   forked groups, at a capacity that drops nothing (ROADMAP.md C.9; the
   config's factor 2 is read). A train step does not fit one card at these
   widths: the Trainer is held on the CPU. One decode step, prefill chunk
   and Preprocessor call run under the profiler.
11. server: the request `Server` on llama3-8b at full width and depth
   (`--server-layers`, default 32) in bfloat16, random weights from seed
   0: a paged engine (16 slots, max_len 1024, chunk 128, page 64, 192
   pages, three quarters of the slots' full caches, the paged kernel),
   shortest-prompt-first admission, a 160-step admission deadline, 2
   retries, a queue limit of 24. 48 prompts of 256-1000 random ids come
   two a serving step, 2 over the budget in the first two steps; a weight
   update streamed in 8 chunks at step 32, one request quarantined at step
   48 (`kill_slot`), an atomic `recompute_kv` update at step 96; it runs
   until every request has settled. It checks that no request is lost and
   each ended done, rejected, shed or quarantined, that the over-budget
   ones were rejected, the stamps (non-decreasing, versions 0, 1 and 2),
   finite behavior logprobs, no live page after the drain, the exact
   launches (the paged decode per layer per decode step, the prefill
   kernel per layer per chunk, `flash_attention` per layer for the
   `recompute_kv`), and before the atomic update one decode step and one
   prefill chunk of the live paged state through the kernels against the
   plain versions (logits relative RMS <= 5e-2). It reports decode step
   and tokens/s, TTFT and latency in steps and ms, admission wait, the
   streamed swap's install steps, retries, shed, deferrals, deadline
   misses and peak memory.
12. faults: a scripted fault plan through `PipelineRL` on granite-3-2b at
   full width, its depth cut from 40 layers to `--faults-layers` (default
   2; the cut is printed), bfloat16, fused loss, remat: two paged engines
   as in pipeline, GRPO groups of 8, batch 16, the Preprocessor, a
   streamed broadcast, checkpoints every step (2 kept) in a temporary
   directory whose free space is checked first, the HealthMonitor, 4
   optimizer steps. The plan: engine 1 crashes and restarts, the trainer
   crashes and restores its checkpoint, the Preprocessor fails, the link
   loses (0.3) and damages (0.3) chunks over the second publication, one
   step is non-finite, the 5th prompt drawn is poisoned, engine 0 hangs
   and restarts after the watchdog finds it. It checks the fault log,
   salvaged = requeued + quarantined with nothing lost, the chunks
   rejected = the corrupt chunks offered to the gate and no torn or
   foreign install, the poisoned step leaving every tensor `torch.equal`,
   the restored version = the durable checkpoint's, the stamps, the
   launches, the Preprocessor against the plain kernels (as in hybrid),
   and the `Evaluator` (a slot engine, `flash_decode`) on the weights
   before and after; then it runs the plan again and holds the fault
   log, every event's simulated time and every counter equal, and reports
   how many sampled tokens and which losses differ. It reports the wall
   time of each fault and recovery, checkpoint save and restore ms and
   bytes, the step times and peak memory.

13. sharded: two gloo ranks on cuda:0 (NCCL refuses two ranks on one
   card): the vocab-parallel fused loss (`kernels/sharded.py`) at
   llama3-8b's head (N 4096, D 4096, V 128256, 64128 columns a rank) in
   bfloat16, forward and backward, each rank launching the fused kernels
   on its slice (counted per rank), its values and gradients against the
   one-rank kernel path and the plain version (2e-2); granite-moe-1b-a400m's
   MoE layer at its published widths (4096 tokens, 16 experts a rank)
   expert-parallel against the unsharded port path (output 2e-2 of its
   largest entry, the aux loss 1e-5, every routing decision equal); the
   times of both, each rank's including the other's share of the card.
14. mesh: the executed multi-rank runtime on four gloo ranks on cuda:0,
   granite-3-2b at published widths (d 2048, 32/8 heads, vocab 49155) in
   bfloat16, its depth cut from 40 layers to `--mesh-layers` (default 4;
   the cut is printed). Gathers take the process group's all-gather
   (`shardctx.redistribute`): DTensor's functional all-gather crashes on
   CUDA tensors over gloo. (a) A slot engine on a 2-rank submesh with the
   default rules (heads split, the cache split along `cache_seq`) against
   the one-rank engine over 20 decode steps, token for token in float32;
   then in bfloat16, with the default rules and with the cache split by
   KV heads instead (no gather), timed per step, with the gathers and the
   lockstep broadcasts per step and the share of tokens equal to the
   one-rank engine's (reported). (b) `record_cosim_trace` on that engine
   and `replay_trace`, within 5%. (c) `PipelineRL(mesh=)`: the trainer on
   all four ranks, two paged engines on disjoint 2-rank submeshes (chunk
   64, page 64, prefix-shared GRPO groups), 3 optimizer steps, a streamed
   broadcast in 8 chunks through `MeshBroadcastExecutor`: every rank's log,
   event times, rollouts and lockstep counts equal, each engine bit for
   bit the trainer's parameters of its version, the stamps, at least one
   executed publication, and each rank's exact launches (the paged decode
   and the prefill kernel of its own engine, the fused forward and
   backward once per step). (d) `execute_weight_update` on the ranks as a
   (2, 2) ("data", "model") mesh in 8 chunks, beside the dry-run's
   `t_collective_s` of the same update. It reports the per-chunk executed
   seconds and bytes, the decode step with and without the gather, the
   trainer step and each rank's peak memory.
15. launch: `repro_torch.launch.train.main` on the card, the tiny
   pipeline for 4 steps with the fused loss, max_len 64 and the reference
   KL: its step lines, the kernels it launched and how often, finite
   rewards and losses, and which attention kernel (if any) no step
   engaged.
16. dryrun: the port's dry-run (`repro_torch.launch.dryrun`) on meta
   DTensors over a fake 128-rank process group, on the host's CPU beside
   the GPU phases (started first, collected last): granite-3-2b x
   {train_4k, decode_32k} with the weight update whole and in 3 chunks,
   deepseek-v3-671b x decode_32k (experts split over "model"),
   `run_disaggregated("granite-3-2b")`, and a one-device trace of the
   train phase's own step, whose FLOP count it prints beside that phase's
   step median (the step's model-FLOP share). The roofline terms are
   arithmetic on H100 data-sheet constants, not timings.

The serve and pipeline profiles report the device ms and launches of the
decode kernel in their profiled step (`kernels`).

After each path phase it prints the device memory still allocated once
the phase has returned (`release`): the phases' objects are freed by
reference counting, with no garbage collection. Then it prints the
`{"kernels": [...]}` summary, the GPU's name and power limit as nvidia-smi
gives them, and, last, `{"ok": true, "device": {...}}`.
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

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("env", "build", "kernels", "serve", "train", "pipeline", "ssm",
          "hybrid", "moe", "mla", "server", "faults", "dryrun", "sharded",
          "mesh", "launch")
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# name: (source, the TPU kernel it replaces, the label of its main-path
# case, the phase that drives its main path)
KERNELS = {
    "flash_decode": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:78", "serve",
                     "serve"),
    "flash_decode_paged": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                           "src/repro/kernels/paged_cache.py:298",
                           "pipeline", "pipeline"),
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                          "src/repro/kernels/prefill_attention.py:103",
                          "serve", "serve"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:75", "serve",
                        "serve"),
    "fused_logprob_fwd": ("src/repro_torch/kernels/csrc/fused_logprob.cu",
                          "src/repro/kernels/fused_logprob.py:256", "train",
                          "train"),
    "fused_logprob_bwd": ("src/repro_torch/kernels/csrc/fused_logprob.cu",
                          "src/repro/kernels/fused_logprob.py:284", "train",
                          "train"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:70", "preprocess", "ssm"),
}
# substrings of the decode kernels' device-function names (the split-KV
# body instantiated with each key-address policy), for the profiles
DECODE_SLOT, DECODE_PAGED = "SlotAddr", "PagedAddr"
N_FINISHED = 24
UPDATE_STEPS = {"atomic": 50, "streamed": 100, "recompute_kv": 150}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


_CYCLES_PER_MS = []


def _cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per millisecond, timed once."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls, after one
    warm-up call, from CUDA events. The calls are queued behind a device
    sleep longer than twice their host cost, so the card runs them back to
    back and the events time the device, not the rate at which the host
    issues them (which bounds a call shorter than its wrapper's host
    work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * iters * host_ms * _cycles_per_ms()) + 1000)
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
                        if "registers" in ln or "spill" in ln
                        or "Performance Loss" in ln]
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


PAGED_YARDSTICK = ("composite: index_select gather of the rows' pages, then "
                   "scaled_dot_product_attention with enable_gqa")


def paged_case(B, H, KV, CL, D, PS, lengths, dtype, seed):
    """flash_decode_paged on a shuffled block table over a pool larger than
    the rows need (a layer slice of a two-layer pool, read in place),
    unallocated blocks on the trash page (filled with large values no read
    may reach), rows 0 and 1 sharing their first pages. Also held bit for
    bit against flash_decode on the same state gathered into the slot
    layout."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    NB = CL // PS
    need = [-(-int(n) // PS) for n in lengths]
    n_pages = 1 + sum(need) + 2 * NB
    free = list(rng.permutation(np.arange(1, n_pages)))
    bt = np.zeros((B, NB), np.int32)
    for b in range(B):
        for j in range(need[b]):
            bt[b, j] = free.pop()
    shared = min(need[0], need[1]) // 2
    bt[1, :shared] = bt[0, :shared]
    pools = [_randn(gen, (2, n_pages, PS, KV, D), dtype) for _ in range(2)]
    for pool in pools:
        pool[:, 0] = 100.0                      # the trash page
    kp, vp = pools[0][1], pools[1][1]
    q = _randn(gen, (B, H, D), dtype)
    bt_t = torch.from_numpy(bt).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    flat = bt_t.flatten().long()

    def gathered(pool):
        return pool.index_select(0, flat).view(B, NB * PS, KV, D)

    mask = (torch.arange(CL, device="cuda")[None] < lens[:, None])[:, None, None]
    qs = q[:, :, None]
    # K/V bytes: each valid (page, offset) once, shared pages once
    valid = {(int(bt[b, p // PS]), p % PS) for b in range(B)
             for p in range(int(lengths[b]))}
    n = float(sum(lengths))
    elt = q.element_size()
    nbytes = ((2 * q.numel() + 2 * len(valid) * KV * D) * elt
              + 4 * (B * NB + B))
    return dict(
        shape=dict(B=B, H=H, KV=KV, CL=CL, D=D, page_size=PS,
                   n_pages=n_pages, shared_blocks=shared,
                   lengths=list(map(int, lengths))),
        kernel=lambda: ops.flash_decode_paged(q, kp, vp, bt_t, lens,
                                              scale=scale),
        plain=lambda: ref.flash_decode_paged_ref(q, kp, vp, bt_t, lens,
                                                 scale=scale),
        bitwise=lambda: ops.flash_decode(q, gathered(kp), gathered(vp), lens,
                                         scale=scale),
        library=None,
        yardstick=lambda: F.scaled_dot_product_attention(
            qs, gathered(kp).transpose(1, 2), gathered(vp).transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True),
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
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    serve_lengths = rng.integers(769, 1025, 16)   # prompts 768-1000, + decode
    paged_lengths = rng.integers(773, 1018, 16)
    paged_lengths[paged_lengths % 16 == 0] += 1   # no length on a page edge
    # the pipeline phase's decode: granite-3-2b heads, 16 slots, max_len 512,
    # prompts 256-384 plus what was sampled
    pipe_lengths = rng.integers(257, 512, 16)
    # lengths on the split edges of the decode kernels at the edge cases'
    # shape (ops._decode_geometry)
    span = ops._decode_geometry(1024, 4, 128, 128, dtype, 0, 4, 8,
                                ops._sm_count(torch.device("cuda"))).span
    edges = [span - 1, span, span + 1, 1024]
    # hymba-1.5b's 25/5 heads (rep 5, d_head 64) and phi3-mini's 32/32
    # (MHA, d_head 96), 512-slot caches
    hymba_lengths, phi3_lengths = [1, 200, 300, 512], [37, 255, 257, 511]
    return [
        ("flash_decode", "serve",
         lambda: decode_case(16, 32, 8, 1024, 128, serve_lengths, dtype, 1)),
        ("flash_decode_paged", "pipeline",
         lambda: paged_case(16, 32, 8, 512, 64, 64, pipe_lengths, dtype, 14)),
        ("flash_decode_paged", "llama-p16",
         lambda: paged_case(16, 32, 8, 1024, 128, 16, paged_lengths, dtype,
                            15)),
        ("flash_decode_paged", "llama-p64",
         lambda: paged_case(16, 32, 8, 1024, 128, 64, paged_lengths, dtype,
                            16)),
        ("flash_decode_paged", "d32-p8-mqa",
         lambda: paged_case(3, 4, 1, 96, 32, 8, [1, 37, 96], dtype, 17)),
        ("flash_decode", "d64-ragged",
         lambda: decode_case(3, 8, 2, 320, 64, [1, 77, 320], dtype, 2)),
        ("flash_decode", "d32-mha-full-ring",
         lambda: decode_case(2, 4, 4, 96, 32, [96, 5], dtype, 3)),
        ("flash_decode", "mqa",
         lambda: decode_case(2, 8, 1, 256, 128, [200, 256], dtype, 4)),
        ("flash_decode", "split-edges",
         lambda: decode_case(4, 32, 8, 1024, 128, edges, dtype, 20)),
        ("flash_decode_paged", "split-edges-p16",
         lambda: paged_case(4, 32, 8, 1024, 128, 16, edges, dtype, 21)),
        ("flash_decode_paged", "split-edges-p64",
         lambda: paged_case(4, 32, 8, 1024, 128, 64, edges, dtype, 22)),
        ("flash_decode", "hymba-rep5-d64",
         lambda: decode_case(4, 25, 5, 512, 64, hymba_lengths, dtype, 23)),
        ("flash_decode_paged", "hymba-rep5-d64-p16",
         lambda: paged_case(4, 25, 5, 512, 64, 16, hymba_lengths, dtype, 24)),
        ("flash_decode", "phi3-mha-d96",
         lambda: decode_case(4, 32, 32, 512, 96, phi3_lengths, dtype, 25)),
        ("flash_decode_paged", "phi3-mha-d96-p32",
         lambda: paged_case(4, 32, 32, 512, 96, 32, phi3_lengths, dtype, 26)),
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
        # granite-3-2b's admission chunk in the pipeline phase
        ("prefill_attention", "pipeline",
         lambda: prefill_case(16, 64, 32, 8, 512, 64, 64, 320, dtype, 18)),
        ("flash_attention", "serve",
         lambda: flash_case(16, 32, 8, 1024, 128, dtype, 10)),
        ("flash_attention", "s200-d64",
         lambda: flash_case(2, 8, 2, 200, 64, dtype, 11)),
        ("flash_attention", "s77-d32-mha",
         lambda: flash_case(1, 4, 4, 77, 32, dtype, 12)),
        ("flash_attention", "s300-window64",
         lambda: flash_case(1, 4, 2, 300, 64, dtype, 13, window=64)),
        # granite-3-2b's dense Preprocessor forward (bucket 512)
        ("flash_attention", "preprocess",
         lambda: flash_case(16, 32, 8, 512, 64, dtype, 19)),
        # the hybrid phase's shapes, hymba-1.5b's 25/5 heads (rep 5, the
        # prefill kernel's thread-copied Q): its admission chunk and its
        # Preprocessor forward
        ("prefill_attention", "hymba-admission",
         lambda: prefill_case(16, 64, 25, 5, 512, 64, 64, 320, dtype, 27)),
        ("flash_attention", "hymba-preprocess",
         lambda: flash_case(16, 25, 5, 512, 64, dtype, 28)),
        # phi3-mini's MHA at d_head 96 (1.5 tensor-core panels)
        ("prefill_attention", "phi3-mha-d96",
         lambda: prefill_case(4, 64, 32, 32, 512, 96, 96, 320, dtype, 29)),
        ("flash_attention", "phi3-mha-d96",
         lambda: flash_case(4, 32, 32, 512, 96, dtype, 30)),
        # qwen3-32b's 64/8 heads at d_head 128, and the moe phase's decode
        # (granite-moe-1b-a400m's 16/8 heads, d_head 64, max_len 512)
        ("flash_decode", "qwen3-gqa-d128",
         lambda: decode_case(16, 64, 8, 1024, 128, serve_lengths, dtype, 31)),
        ("flash_decode", "granite-moe",
         lambda: decode_case(16, 16, 8, 512, 64, pipe_lengths, dtype, 32)),
        # the moe phase's admission chunk and Preprocessor forward
        # (granite-moe-1b-a400m's 16/8 heads, rep 2, d_head 64)
        ("prefill_attention", "granite-moe-admission",
         lambda: prefill_case(16, 64, 16, 8, 512, 64, 64, 320, dtype, 33)),
        ("flash_attention", "granite-moe-preprocess",
         lambda: flash_case(16, 16, 8, 512, 64, dtype, 34)),
        # absorbed MLA at deepseek-v3's widths (one KV head, Dk 512 + 64,
        # Dv 512, 128 heads; the wide instance): the mla phase's admission
        # chunk, and one against a cache of 1024
        ("prefill_attention", "mla-admission",
         lambda: prefill_case(16, 64, 128, 1, 512, 576, 512, 320, dtype, 35)),
        ("prefill_attention", "mla-cl1024",
         lambda: prefill_case(16, 64, 128, 1, 1024, 576, 512, 512, dtype,
                              36)),
        # the wide instance off its main shape: a block of 8 rows after a
        # full one on a ring wrapped once; narrower head dims, whose
        # unloaded panels it zeroes, with two KV heads
        ("prefill_attention", "wide-ragged-ring",
         lambda: prefill_case(2, 12, 6, 1, 48, 576, 512, 72, dtype, 37)),
        ("prefill_attention", "wide-dk320-dv272",
         lambda: prefill_case(2, 8, 16, 2, 96, 320, 272, 136, dtype, 38)),
    ]


# fused_logprob: value, dh and dW against the blocked twin. Gradients are
# held relative to the largest entry of the plain version's: the two sum
# the logits gradient over V in another order (f32), and in bfloat16 both
# round the same float32 sums once (a flipped last bit is 2^-8 relative).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
        ("mamba2-head", dict(N=4096, D=2560, V=50280, transpose=False)),
        # the hybrid and moe phases' train batches: hymba-1.5b's head (V
        # 32001, rows staged for TMA) and granite-moe-1b-a400m's
        ("hymba-head", dict(N=4096, D=1600, V=32001, transpose=False)),
        ("granite-moe-head", dict(N=4096, D=1024, V=49155, transpose=False)),
        ("tied-VD", dict(N=512, D=256, V=1000, transpose=True)),
        ("v50", dict(N=16, D=64, V=50, transpose=False)),
        ("v33-tied", dict(N=24, D=32, V=33, transpose=True)),
        ("ragged-n300", dict(N=300, D=128, V=777, transpose=False)),
        ("dw-chunks4", dict(N=520, D=64, V=300, transpose=True, dw_chunks=4)),
        # the hybrid and moe Preprocessors' forward (16 x 512 tokens)
        ("hymba-preprocess", dict(N=8192, D=1600, V=32001, transpose=False,
                                  bwd=False)),
        ("granite-moe-preprocess", dict(N=8192, D=1024, V=49155,
                                        transpose=False, bwd=False)),
        # deepseek-v3's untied head: the mla phase's Preprocessor call (8 x
        # 512 tokens, main and MTP stats) and a train batch of 4 x 1024
        ("deepseek-head", dict(N=4096, D=7168, V=129280, transpose=False)),
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
    from repro_torch.kernels import ops
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
                           route=ops.route(name, dtype),
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
    """Each attention kernel's cases against their plain versions, in
    float32 and bfloat16; every row names the kernel the dtype took
    (`ops.route`)."""
    from repro_torch.kernels import ops
    results, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, make in kernel_cases(dtype):
            case = make()
            out = case["kernel"]()
            exp = case["plain"]()
            torch.cuda.synchronize()
            err = float((out.float() - exp.float()).abs().max())
            ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
            iters = 20 if label in ("serve", "pipeline", "preprocess") else 5
            row = dict(name=name, label=label, shape=case["shape"],
                       dtype=str(dtype).replace("torch.", ""),
                       route=ops.route(name, dtype), max_err=err,
                       tol=TOL[dtype], ok=ok,
                       kernel_ms=cuda_ms(case["kernel"], iters),
                       plain_ms=cuda_ms(case["plain"], max(iters // 4, 2)),
                       library_ms=None,
                       bound_ms=case["bound"][0], bound_by=case["bound"][1])
            if case["library"]:
                try:
                    row["library_ms"] = cuda_ms(case["library"], iters)
                except RuntimeError as e:
                    # the library call refuses the shape: no time, its error
                    row["library_error"] = str(e).splitlines()[0][:300]
            if "bitwise" in case:
                # the paged kernel against flash_decode on the gathered view
                same = bool(torch.equal(out, case["bitwise"]()))
                row.update(bitwise_vs_flash_decode=same)
                ok = ok and same
                row["ok"] = ok
            if "yardstick" in case:
                row.update(yardstick_ms=cuda_ms(case["yardstick"], iters),
                           yardstick=PAGED_YARDSTICK)
            results.append(row)
            if not ok:
                failures.append(f"{name}/{label}/{row['dtype']}: err {err}"
                                f"{row.get('bitwise_vs_flash_decode', '')}")
            del case, out, exp
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "gpu": gpu, "kernels": results})
    if failures:
        raise SystemExit("kernel disagrees with its plain version: "
                         + "; ".join(failures))
    return results


# ssd_scan: y and the final state against the plain chunked SSD with the
# tolerances `tests/test_kernels.py` holds the Pallas kernel to: |out -
# plain| <= atol + rtol * |plain|. The plain version runs in float64 on the
# same input values: at mamba2's widths the scan's sums cancel (|y| up to
# ~400 where some entries are ~1), and the float32 plain version is itself
# up to 1.15x the float32 tolerance away from the float64 one (measured on
# the H100), so two float32 evaluations cannot be held to it against each
# other. The float32 plain version's error is reported beside.
SSD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}
SSD_LIBRARY = "none (no PyTorch call computes the scan)"


def ssd_case(b, l, h, p, g, n, chunk, dtype, seed, views=False, skew=0):
    """Inputs and callables of one ssd_scan case, in the law of the JAX
    package's tests: x, B, C unit normal, dt = softplus(normal), A =
    -exp(normal). `views`: x, B and C are slices of one (b, l, h*p + 2gn)
    tensor, as the model passes its conv output; `skew` elements more
    before x and in each row leave them off 16-byte alignment."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if views:
        xbc = _randn(gen, (b, l, skew + h * p + 2 * g * n), dtype)[..., skew:]
        x = xbc[..., :h * p].view(b, l, h, p)
        B = xbc[..., h * p:h * p + g * n].view(b, l, g, n)
        C = xbc[..., h * p + g * n:].view(b, l, g, n)
    else:
        x = _randn(gen, (b, l, h, p), dtype)
        B = _randn(gen, (b, l, g, n), dtype)
        C = _randn(gen, (b, l, g, n), dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
    elt = x.element_size()
    # bytes: x, B, C, dt and A read once, y and the state written once;
    # operations: per (row, head, chunk the kernel walks) the causal
    # triangle T of C.B^T and of scores.(dt x), then C.state and
    # B^T.(decay dt x)
    q = ops._ssd_geometry(h, p, g, n, chunk, dtype).q
    nc = l // q
    tri = q * (q + 1) // 2
    nbytes = elt * (2 * b * l * h * p + 2 * b * l * g * n) \
        + 4 * (b * l * h + h + b * h * n * p)
    flops = 2.0 * b * h * nc * (tri * n + tri * p + 2 * q * n * p)
    return dict(
        shape=dict(b=b, l=l, h=h, p=p, g=g, n=n, chunk=chunk, views=views,
                   skew=skew, kernel_chunk=q),
        args=(x, dt, A, B, C),
        kernel=lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk),
        plain=lambda: ref.ssd_scan_ref(x, dt, A, B, C, chunk=chunk),
        exact=lambda: ref.ssd_scan_ref(*(t.double() for t in (x, dt, A, B,
                                                              C)),
                                       chunk=chunk),
        bound=_bound(nbytes, flops, dtype))


def ssd_cases():
    """(label, args) of ssd_scan: mamba2-2.7b's Preprocessor call (16 x 512,
    the main path), its train shape (4 x 1024), awkward shapes (heads
    repeating over 2 groups, P 32, N 16, chunks of 16 and 32, one chunk),
    then hymba-1.5b's Preprocessor call (50 heads of 64, state 16), and
    the widths the layout reaches beyond them: N 256 (float32 walks
    32-token chunks), P 128 and 256, a chunk of 128 and unaligned views."""
    mamba = dict(h=80, p=64, g=1, n=128, chunk=64, views=True)
    return [
        ("preprocess", dict(b=16, l=512, **mamba)),
        ("train-shape", dict(b=4, l=1024, **mamba)),
        ("g2-p32-n16-c16", dict(b=2, l=96, h=6, p=32, g=2, n=16, chunk=16)),
        ("g3-p16-n8-c32", dict(b=1, l=96, h=6, p=16, g=3, n=8, chunk=32)),
        ("one-chunk", dict(b=3, l=64, h=4, p=64, g=1, n=128, chunk=64)),
        ("hymba", dict(b=16, l=512, h=50, p=64, g=1, n=16, chunk=64,
                       views=True)),
        ("n256", dict(b=2, l=256, h=4, p=64, g=1, n=256, chunk=64)),
        ("p128-n128", dict(b=2, l=256, h=4, p=128, g=1, n=128, chunk=64)),
        ("p256-n64", dict(b=1, l=128, h=2, p=256, g=1, n=64, chunk=64)),
        ("c128-g2", dict(b=2, l=256, h=4, p=64, g=2, n=64, chunk=128)),
        ("unaligned", dict(b=2, l=128, h=6, p=32, g=2, n=16, chunk=32,
                           views=True, skew=1)),
    ]


def phase_ssd(gpu: str) -> list:
    """ssd_scan against its plain version (in float64, see SSD_TOL) in
    float32 and bfloat16, y and the final state; and a differentiated call
    must raise."""
    from repro_torch.kernels import ops
    results, failures = [], []

    def over(outs, exps, atol, rtol):
        """Max abs errors of (y, state) and their largest ratio to the
        tolerance."""
        errs, ratio = [], 0.0
        for o, e in zip(outs, exps):
            d = (o.double() - e.double()).abs()
            errs.append(float(d.max()))
            ratio = max(ratio, float((d / (atol + rtol * e.double().abs()))
                                     .max()))
        return errs, ratio

    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = SSD_TOL[dtype]
        for seed, (label, args) in enumerate(ssd_cases()):
            case = ssd_case(dtype=dtype, seed=200 + seed, **args)
            out, plain, exact = case["kernel"](), case["plain"](), \
                case["exact"]()
            torch.cuda.synchronize()
            errs, ratio = over(out, exact, atol, rtol)
            errs32, ratio32 = over(out, plain, atol, rtol)
            _, ratio_plain = over(plain, exact, atol, rtol)
            finite = all(bool(torch.isfinite(t).all()) for t in out)
            ok = finite and ratio <= 1.0
            main = label in ("preprocess", "train-shape")
            row = dict(name="ssd_scan", label=label, shape=case["shape"],
                       dtype=str(dtype).replace("torch.", ""),
                       route=ops.route("ssd_scan", dtype), max_err=max(errs), max_err_y_state=errs,
                       err_measure="max |d| / (atol + rtol |plain|), plain "
                                   "in float64",
                       err_value=ratio, tol=[atol, rtol], ok=ok,
                       vs_plain_same_dtype={"max_err_y_state": errs32,
                                            "err_value": ratio32},
                       plain_same_dtype_vs_float64=ratio_plain,
                       kernel_ms=cuda_ms(case["kernel"], 10 if main else 5),
                       plain_ms=cuda_ms(case["plain"], 3),
                       library_ms=None, library=SSD_LIBRARY,
                       bound_ms=case["bound"][0], bound_by=case["bound"][1])
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            x, _, _, B, C = case["args"]
            row["cp_async"] = ops._aligned16(x, B, C)
            results.append(row)
            if not ok:
                failures.append(f"ssd_scan/{label}/{row['dtype']}: errors "
                                f"{errs}, {ratio} of the tolerance")
            del case, out, plain, exact, x, B, C
            torch.cuda.empty_cache()
    # a differentiated call would cut the gradient: the wrapper refuses it
    case = ssd_case(2, 64, 4, 16, 1, 16, 16, torch.float32, 299)
    x, dt, A, B, C = case["args"]
    try:
        ops.ssd_scan(x.clone().requires_grad_(True), dt, A, B, C, chunk=16)
        refused = False
    except RuntimeError as e:
        refused = "forward-only" in str(e)
    if not refused:
        failures.append("ssd_scan ran a differentiated call")
    emit({"phase": "kernels", "kernel": "ssd_scan", "gpu": gpu,
          "refuses_autograd": refused, "kernels": results})
    if failures:
        raise SystemExit("ssd_scan disagrees with its plain version: "
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


def _profile(fn, dev, top: int = 8, match=None, ranges=()) -> dict:
    """One call of `fn` under torch.profiler (CUPTI): wall time, the summed
    device time of its kernels, their share of the wall time (one stream,
    so kernels do not overlap; the profiler's own host cost is inside the
    wall time), the kernels that take the most device time, for each
    `match` entry (label: a substring of kernel names) the device ms and
    launches of the kernels whose names hold it, and for each name in
    `ranges` (a `torch.profiler.record_function` range inside `fn`) the
    device ms of the kernels launched within it and its calls."""
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
        # kernel rows only: an operator's row repeats its kernels' time,
        # and a range's device row is its span on the timeline
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key in ranges:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    busy_ms = sum(r[0] for r in rows)
    matched = {label: {"ms": sum(r[0] for r in rows if sub in r[1]),
                       "calls": sum(r[2] for r in rows if sub in r[1])}
               for label, sub in (match or {}).items()}
    for name in ranges:
        # a host range's device time: the kernels launched inside it
        evs = [e for e in prof.events() if e.name == name
               and e.device_type == torch.autograd.DeviceType.CPU]
        ms = sum(e.device_time_total for e in evs) / 1e3
        matched[name] = {"ms": ms, "calls": len(evs),
                         "share_of_busy": ms / busy_ms if busy_ms else None}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if busy_ms else None,
            "kernels": matched,
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
    for name, spec in KERNELS.items():
        if spec[3] == "serve" and launches[name] <= 0:
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
            "decode_step": _profile(lambda: eng.step(), dev,
                                    match={"flash_decode": DECODE_SLOT}),
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
# phases 6-9: the PipelineRL loops
# ---------------------------------------------------------------------------

PIPE_GROUP = 8            # GRPO group: each prompt is yielded 8 times
PIPE_CHECK_STEPS = 32     # decode steps of the paged-against-slots check
# the broadcast interconnect of the simulated clock moves one publication
# in this many decode steps of the phase's batch (the Appendix-A default
# is set for the tiny config's kilobytes, not granite's gigabytes)
PIPE_BCAST_STEPS = 8


def _paged_against_slots(cfg, params, dev, n_prompts: int,
                         group: int = 1) -> dict:
    """The same 16 prompts through a paged engine (page_size 64, the paged
    kernel) and a slot engine at one seed, for PIPE_CHECK_STEPS decode
    steps: tokens, behavior logprobs and version stamps must agree bit for
    bit. With `group` > 1 the prompts come in groups of that many identical
    ones and the paged engine shares their prefix: one prefill per group,
    the rest forked (with a hybrid config, the leader's conv and SSD rows
    copied into the forks)."""
    import dataclasses

    from repro_torch import EngineConfig, GenerationEngine
    from repro_torch.data.math_task import Problem

    rng = np.random.default_rng(1)
    prompts = [p for n in rng.integers(256, 385, n_prompts // group)
               for p in [rng.integers(3, cfg.vocab_size, int(n)).tolist()]
               * group]
    ec = EngineConfig(n_slots=n_prompts, max_len=512, prefill_chunk=64,
                      temperature=1.0)
    out, forks = {}, 0
    for name, e in (("slots", ec),
                    ("paged", dataclasses.replace(
                        ec, cache="paged", page_size=64,
                        paged_attention="kernel", prefix_sharing=group > 1))):
        it = iter([Problem(list(p), 0) for p in prompts])
        eng = GenerationEngine(cfg, params, e, lambda: next(it, None),
                               seed=7, device=dev)
        eng.refill()
        forks += eng.prefix_forks
        times = []
        for _ in range(PIPE_CHECK_STEPS):
            t0 = time.perf_counter()
            eng.step()                  # ends in the `finished` readback
            times.append(time.perf_counter() - t0)
        out[name] = (eng.state["tokens"].cpu(), eng.state["lp"].cpu(),
                     eng.ver_buf.copy(), statistics.median(times[1:]) * 1e3)
        del eng
    (tS, lS, vS, mS), (tP, lP, vP, mP) = out["slots"], out["paged"]
    return {"prompts": n_prompts, "group": group, "prefix_forks": forks,
            "decode_steps": PIPE_CHECK_STEPS,
            "decode_step_ms_median": {"slots": mS, "paged": mP},
            "tokens_equal": bool(torch.equal(tS, tP)),
            "logprobs_bitwise": bool(torch.equal(lS, lP)),
            "logprobs_max_diff": float((lS - lP).abs().max()),
            "stamps_equal": bool((vS == vP).all())}


# ---------------------------------------------------------------------------
# the loop phases' shared pieces (pipeline, ssm, hybrid, moe)
# ---------------------------------------------------------------------------

def _grpo_source(rng, vocab_size: int, lengths=(256, 384)):
    """Prompts of `lengths` (256-384) random ids in GRPO groups: each is
    yielded PIPE_GROUP times in a row."""
    from repro_torch.data.math_task import Problem
    group = {"left": 0, "ids": None}

    def source():
        if group["left"] == 0:
            n = int(rng.integers(lengths[0], lengths[1] + 1))
            group["ids"] = rng.integers(3, vocab_size, n).tolist()
            group["left"] = PIPE_GROUP
        group["left"] -= 1
        # one Problem per draw: a fault plan marks a draw, not its group
        return Problem(group["ids"], 0)

    return source


def _random_source(rng, vocab_size: int):
    """Prompts of 256-384 random ids, each its own."""
    from repro_torch.data.math_task import Problem

    def source():
        n = int(rng.integers(256, 385))
        return Problem(rng.integers(3, vocab_size, n).tolist(), 0)

    return source


def _loop_parts(cfg, ec, pc, source, dev, fault_plan=None):
    """A PipelineRL at `cfg` with random weights from seed 0, its Trainer
    (lr 1e-3) and Preprocessor (kl_coef 0.05), a broadcast that takes
    PIPE_BCAST_STEPS decode steps of a lone engine on the simulated clock,
    and `fault_plan`."""
    import dataclasses

    from repro_torch import (AdamConfig, HardwareModel, PipelineRL,
                             PreprocessConfig, Preprocessor, RLConfig,
                             Trainer)
    from repro_torch.core.weights import tree_bytes
    from repro_torch.data.math_task import MathTask
    from repro_torch.models import model as M

    params = M.init_params(cfg, seed=0, device=dev)
    trainer = Trainer(cfg, params, rl=RLConfig(), adam=AdamConfig(lr=1e-3),
                      device=dev)
    pre = Preprocessor(cfg, params, PreprocessConfig(kl_coef=0.05,
                                                     max_len=ec.max_len),
                       device=dev)
    base = HardwareModel()
    per_chip = ec.n_slots / (pc.n_chips - pc.train_chips)
    hw = dataclasses.replace(base, bcast_bytes_per_flash=tree_bytes(params)
                             / (PIPE_BCAST_STEPS * base.step_cost(per_chip)))
    p = PipelineRL(cfg, params, MathTask(), ec, pc, hw=hw, trainer=trainer,
                   preprocessor=pre, prompt_source=source,
                   fault_plan=fault_plan, device=dev)
    return p, trainer, pre


def _run_loop(p, trainer, pre, dev) -> dict:
    """Run `p` to its end with its engines' steps and refills, the
    Preprocessor's forwards and the trainer's steps timed (host clock,
    synced), the launch counts set to 0 just before the run and read just
    after, and every delivered rollout kept. Each refill records the rows
    it admitted, prefilled and forked and how many copies of each distinct
    prompt it took; a paged engine's live pages are read after each step."""
    from repro_torch.kernels import ops
    rec = {"step_s": [], "chunk_ms": [], "refill_s": 0.0, "refills": [],
           "live_pages": [], "pre_calls": [], "train": []}
    raw_train, raw_ref = trainer.step, pre._ref_logprobs
    t_start = [0.0]

    def wrap(eng):
        raw_step, raw_refill = eng.step, eng.refill

        def timed_step(*a, **k):
            t0 = time.perf_counter()
            done = raw_step(*a, **k)
            rec["step_s"].append(time.perf_counter() - t0)
            if eng.allocator is not None:
                rec["live_pages"].append(eng.allocator.live_pages)
            return done

        def timed_refill(*a, **k):
            n_inv = eng.prefill_invocations
            pre_, fork_ = eng.prompt_prefills, eng.prefix_forks
            rows = np.where(~eng._host_active)[0]
            t0 = time.perf_counter()
            n = raw_refill(*a, **k)
            _sync(dev)
            dt_s = time.perf_counter() - t0
            rec["refill_s"] += dt_s
            if eng.prefill_invocations > n_inv:
                rec["chunk_ms"].append(dt_s * 1e3
                                       / (eng.prefill_invocations - n_inv))
            if n:
                new = [tuple(eng.problems[s].prompt_ids) for s in rows
                       if eng._host_active[s]]
                rec["refills"].append({
                    "admitted": n, "copies": sorted(new.count(key)
                                                    for key in set(new)),
                    "prefills": eng.prompt_prefills - pre_,
                    "forks": eng.prefix_forks - fork_})
            return n

        eng.step, eng.refill = timed_step, timed_refill

    def timed_ref(tokens, *a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        out = raw_ref(tokens, *a, **k)
        _sync(dev)
        rec["pre_calls"].append({"rows": int(tokens.shape[0]),
                                 "bucket": int(tokens.shape[1]),
                                 "ms": (time.perf_counter() - t0) * 1e3})
        return out

    def timed_train(*a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        m = raw_train(*a, **k)
        _sync(dev)
        rec["train"].append({"train_ms": (time.perf_counter() - t0) * 1e3,
                             "at_s": time.perf_counter() - t_start[0]})
        return m

    seen, raw_deliver = [], [a.deliver for a in p.actors]

    def keep(deliver):
        def kept_deliver(rollouts, t):
            seen.extend(rollouts)
            deliver(rollouts, t)
        return kept_deliver

    for eng in p.engines:
        wrap(eng)
    for actor, deliver in zip(p.actors, raw_deliver):
        actor.deliver = keep(deliver)
    trainer.step, pre._ref_logprobs = timed_train, timed_ref
    ops.reset_launches()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_start[0] = time.perf_counter()
    log = p.run()
    _sync(dev)
    rec["run_s"] = time.perf_counter() - t_start[0]
    rec["launches"] = dict(ops.launches)
    rec["peak_mem_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                           if dev.type == "cuda" else None)
    # back to the class's methods: an instance attribute holding a bound
    # method of its own object would be a reference cycle
    for eng in p.engines:
        del eng.step, eng.refill
    del trainer.step, pre._ref_logprobs
    for actor, deliver in zip(p.actors, raw_deliver):
        actor.deliver = deliver
    rec.update(log=log, seen=seen,
               tokens=sum(e.tokens_generated for e in p.engines))
    return rec


def _loop_checks(rec, p) -> tuple:
    """The checks every loop phase makes: three optimizer steps with finite
    losses, a completed streamed swap, non-decreasing stamps, finite
    behavior logprobs <= 0. Returns (failures, the steps' record)."""
    log, seen, bad = rec["log"], rec["seen"], []
    steps = [{"version": r["version"], "wall_s": w["at_s"],
              "train_ms": w["train_ms"], "sim_time": r["time"],
              "reward": r["reward"], "ess": r["ess"], "max_lag": r["max_lag"],
              "loss": r["loss"]} for r, w in zip(log, rec["train"])]
    if [r["version"] for r in log] != [1, 2, 3]:
        bad.append(f"optimizer steps {[r['version'] for r in log]}")
    if not all(np.isfinite(r["loss"]) for r in log):
        bad.append(f"losses {[r['loss'] for r in log]}")
    bs = p.broadcast_stats()
    if p.engine.version < 1 or bs["engines"][0]["streams_completed"] < 1:
        bad.append(f"engine version {p.engine.version}, broadcast {bs}")
    if not all((np.diff(r.weight_versions) >= 0).all() for r in seen):
        bad.append("a rollout's version stamps decrease")
    lp_ok = all(np.isfinite(r.behavior_logprobs).all()
                and (r.behavior_logprobs[r.prompt_len:] <= 0).all()
                for r in seen)
    if not seen or not lp_ok:
        bad.append(f"behavior logprobs of {len(seen)} rollouts not finite "
                   f"and <= 0")
    return bad, steps


def _fork_checks(rec, eng) -> list:
    """A prefix-sharing engine's refills: every distinct prompt prefilled
    once, its copies forked (PIPE_GROUP - 1 forks per prefill for whole
    groups); the block tables hold; `reset_slots` returns every page."""
    bad = []
    for f in rec["refills"]:
        if f["prefills"] != len(f["copies"]) \
                or f["forks"] != f["admitted"] - len(f["copies"]):
            bad.append(f"refill {f}: identical prompts were not forked")
    whole = [f for f in rec["refills"]
             if all(c == PIPE_GROUP for c in f["copies"])]
    forks = sum(f["forks"] for f in whole)
    prefills = sum(f["prefills"] for f in whole)
    if not whole or forks != (PIPE_GROUP - 1) * prefills:
        bad.append(f"whole groups: {prefills} prefills, {forks} forks")
    try:
        eng.tables.check()
    except AssertionError as e:
        bad.append(f"block tables: {e}")
    eng.reset_slots()
    if eng.allocator.free_pages != eng.allocator.n_pages - 1:
        bad.append(f"reset_slots left {eng.allocator.live_pages} pages live")
    return bad


def _want_launches(cfg, rec, decode_kernel: str | None) -> dict:
    """Launches the loop must have made: the decode kernel once per layer
    per decode step, `flash_attention` per layer per Preprocessor call,
    `ssd_scan` per layer per call whose bucket the scan's gate takes, the
    fused forward per Preprocessor call and train step, its backward per
    train step (`prefill_attention` is held to the prefill chunks apart)."""
    calls = rec["pre_calls"]
    want = {"fused_logprob_fwd": len(calls) + len(rec["train"]),
            "fused_logprob_bwd": len(rec["train"])}
    if cfg.has_attention:
        want[decode_kernel] = cfg.n_layers * len(rec["step_s"])
        want["flash_attention"] = cfg.n_layers * len(calls)
    if cfg.has_ssm:
        want["ssd_scan"] = cfg.n_layers * sum(
            c["bucket"] % cfg.ssm_chunk == 0 for c in calls)
    return want


def _launch_checks(cfg, rec, eng, want) -> list:
    bad = [f"{name}: {rec['launches'][name]} launches, expected {n}"
           for name, n in want.items() if rec["launches"][name] != n]
    chunks = cfg.n_layers * eng.prefill_invocations if cfg.has_attention \
        else 0
    if rec["launches"]["prefill_attention"] != chunks:
        bad.append(f"prefill_attention: {rec['launches']['prefill_attention']}"
                   f" launches for {eng.prefill_invocations} chunks")
    off_path = [k for k in KERNELS if k not in want
                and k != "prefill_attention" and rec["launches"][k]]
    if off_path:
        bad.append(f"kernels off the path launched: {off_path}")
    return bad


PRE_TOL = 5e-2


def _preprocess_against_plain(pre, batch, faults=()) -> dict:
    """The Preprocessor's reference logprobs on `batch` through the kernels
    against the same through their plain versions (on copies: `process`
    writes its results into the rollouts), by `_path_check`."""
    import dataclasses

    def ref_logprobs():
        done = pre.process([dataclasses.replace(r) for r in batch])
        return [r.ref_logprobs for r in done]

    return _path_check(ref_logprobs, faults)


def _path_check(rows_of, faults=()) -> dict:
    """`rows_of()`, a list of 1-D arrays (a rollout's logprobs, a
    position's logits) computed through the model's kernels, against the
    same through their plain versions. The measure is the RMS error over
    the RMS of the plain values less each row's mean, <= PRE_TOL: with
    random weights a logprob is mostly its row's -log V offset, which no
    fault of the model's layers moves, so the spread about the mean is the
    scale of what the layers decide (`rel_rms`, over the raw RMS, is
    reported too). Each of `faults`, a (label, context manager, gate)
    triple, plants a fault in the kernel path as a control; the measure
    must fail each one whose gate is set, and reads the others to show
    what it cannot see."""
    rows_k = rows_of()
    with plain_kernels():
        rows_p = rows_of()
    lp_p = np.concatenate(rows_p)
    spread = np.linalg.norm(np.concatenate([r - r.mean() for r in rows_p]))

    def measure(rows):
        d = np.concatenate(rows) - lp_p
        return {"rel_rms_centered": float(np.linalg.norm(d) / spread),
                "rel_rms": float(np.linalg.norm(d) / np.linalg.norm(lp_p)),
                "rms_err": float(np.sqrt(np.mean(d * d))),
                "max_err": float(np.abs(d).max())}

    check = {"rows": len(rows_p), **measure(rows_k),
             "plain_rms_centered": float(spread / np.sqrt(lp_p.size)),
             "tol_rel_rms_centered": PRE_TOL}
    check["ok"] = check["rel_rms_centered"] <= PRE_TOL
    check["planted_faults"] = []
    for label, fault, gate in faults:
        with fault:
            got = measure(rows_of())
        got.update(fault=label, gate=gate,
                   caught=got["rel_rms_centered"] > PRE_TOL)
        check["planted_faults"].append(got)
        check["ok"] = check["ok"] and (got["caught"] or not gate)
    return check


def _faults(cfg) -> list:
    """The path check's controls. Gated: `flash_attention` with a fifth of
    its heads zeroed in every layer (a kernel's fault hits every call) and
    in layer 0 alone. Read only, for a config with an SSM branch: the
    scan's fault in every layer, which random weights hide (the scan's
    term of y is a vanishing share of the D x skip's, PERF.md)."""
    L, what = cfg.n_layers, "a fifth of the heads zeroed in"
    out = [(f"flash_attention, {what} every layer",
            planted_fault("flash_attention", L), True),
           (f"flash_attention, {what} layer 0",
            planted_fault("flash_attention", L, 0), True)]
    if cfg.has_ssm:
        out.append((f"ssd_scan, {what} every layer",
                    planted_fault("ssd_scan", L), False))
    return out


@contextlib.contextmanager
def planted_fault(kernel: str, n_layers: int, layer=None):
    """A control for the path check: `ops.<kernel>` (`flash_attention` or
    `ssd_scan`, called once per layer of a forward, in order) with its
    first fifth of heads' output zeroed in layer `layer`, or in every
    layer."""
    from repro_torch.kernels import ops
    saved = getattr(ops, kernel)
    calls = [0]

    def faulty(*a, **k):
        out = saved(*a, **k)
        calls[0] += 1
        if layer is None or (calls[0] - 1) % n_layers == layer:
            y, dim = ((out, 1) if kernel == "flash_attention"
                      else (out[0], 2))
            y.narrow(dim, 0, max(1, y.shape[dim] // 5)).zero_()
        return out

    setattr(ops, kernel, faulty)
    try:
        yield
    finally:
        setattr(ops, kernel, saved)


def _loop_result(phase, gpu, cfg, ec, pc, rec, steps, p) -> dict:
    """The measures every loop phase reports."""
    import dataclasses
    steady = rec["step_s"][1:]
    pre_calls = rec["pre_calls"]
    bs = p.broadcast_stats()
    return {"phase": phase, "gpu": gpu, "config": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "d_head": cfg.d_head,
            "vocab": cfg.vocab_size,
            "dtype": str(cfg.dtype).replace("torch.", ""),
            "engine": dataclasses.asdict(ec),
            "pipeline": {k: v for k, v in dataclasses.asdict(pc).items()
                         if k != "health"},
            "bcast_bytes_per_flash": p.hw.bcast_bytes_per_flash,
            "run_s": rec["run_s"], "opt_steps": steps,
            "rollouts": len(rec["seen"]),
            "rollouts_correct": sum(r.reward >= 1.0 for r in rec["seen"]),
            "rollout_versions": sorted(
                {int(v) for r in rec["seen"]
                 for v in r.weight_versions[r.prompt_len:]}),
            "decode_steps": len(rec["step_s"]),
            "decode_step_ms_median": (statistics.median(steady) * 1e3
                                      if steady else None),
            "generated_tokens_per_s": rec["tokens"] / sum(rec["step_s"]),
            "tokens_generated": rec["tokens"],
            "decode_s": sum(rec["step_s"]), "refill_s": rec["refill_s"],
            "prefill_invocations": p.engine.prefill_invocations,
            "prefill_chunk_ms_median": (statistics.median(rec["chunk_ms"])
                                        if rec["chunk_ms"] else None),
            "preprocess_calls": pre_calls,
            "preprocess_ms_per_call": (statistics.median(
                [c["ms"] for c in pre_calls]) if pre_calls else None),
            "train_step_ms": [w["train_ms"] for w in rec["train"]],
            "engine_version": p.engine.version,
            "broadcast": {"pause_per_update":
                          bs["engines"][0]["pause_per_update"],
                          "streams_completed":
                          bs["engines"][0]["streams_completed"],
                          "published": bs["published"]},
            "peak_mem_gib": rec["peak_mem_gib"],
            "launches": rec["launches"]}


def _paged_result(rec, eng) -> dict:
    """A prefix-sharing paged engine's counters, read before its reset."""
    return {"prompt_prefills": eng.prompt_prefills,
            "prefix_forks": eng.prefix_forks,
            "pages_copied": eng.pages_copied,
            "slots_preempted": eng.slots_preempted,
            "pages": {"live_at_end": eng.allocator.live_pages,
                      "peak_live": max(rec["live_pages"], default=0),
                      "pool": eng.allocator.n_pages},
            "refills": rec["refills"]}


def _finish(phase, res, bad) -> dict:
    res["failures"] = bad
    emit(res)
    if bad:
        raise SystemExit(f"{phase} phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# phase 6: the PipelineRL loop on paged engines
# ---------------------------------------------------------------------------

def phase_pipeline(gpu: str, n_layers: int, device="cuda") -> dict:
    """This slice's path on `device` (the card; a CPU run rehearses the
    phase's logic at a reduced config and measures nothing): PipelineRL on
    one paged engine with prefix-shared GRPO groups, the Preprocessor, the
    trainer with the group baseline, and the streamed broadcast."""
    import dataclasses

    from repro_torch import EngineConfig, PipelineConfig, get_config

    cfg = dataclasses.replace(get_config("granite-3-2b"), fused_loss=True,
                              remat=True)
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device)
    ec = EngineConfig(n_slots=16, max_len=512, prefill_chunk=64,
                      cache="paged", page_size=64, paged_attention="kernel",
                      prefix_sharing=True, temperature=1.0)
    pc = PipelineConfig(batch_size=16, n_opt_steps=3, pack_rows=4,
                        pack_seq=1024, n_engines=1, broadcast="streamed",
                        broadcast_chunks=8, group_baseline=True)
    p, trainer, pre = _loop_parts(
        cfg, ec, pc, _grpo_source(np.random.default_rng(0), cfg.vocab_size),
        dev)
    eng = p.engine
    rec = _run_loop(p, trainer, pre, dev)
    bad, steps = _loop_checks(rec, p)
    want = _want_launches(cfg, rec, "flash_decode_paged")
    bad += _launch_checks(cfg, rec, eng, want)
    # one paged decode step of the running engine under the profiler
    profile = (_profile(lambda: eng.step(), dev,
                        match={"flash_decode_paged": DECODE_PAGED})
               if dev.type == "cuda" else None)
    res = _loop_result("pipeline", gpu, cfg, ec, pc, rec, steps, p)
    res.update(_paged_result(rec, eng))
    bad += _fork_checks(rec, eng)
    check = _paged_against_slots(cfg, trainer.params, dev, ec.n_slots)
    if not (check["tokens_equal"] and check["logprobs_bitwise"]
            and check["stamps_equal"]):
        bad.append(f"paged against slots: {check}")
    res.update(expected_launches=want, paged_against_slots=check,
               profile=profile)
    return _finish("pipeline", res, bad)


# ---------------------------------------------------------------------------
# phase 7: Mamba2 (SSM) through the PipelineRL loop
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_ssd():
    """Route the model's SSD scan through its plain version, on the card,
    for one comparison."""
    from repro_torch.kernels import ops, ref
    saved = ops.ssd_scan
    ops.ssd_scan = ref.ssd_scan_ref
    try:
        yield
    finally:
        ops.ssd_scan = saved


def phase_ssm(gpu: str, n_layers: int, device="cuda") -> dict:
    """This slice's path on `device` (the card; a CPU run rehearses the
    phase's logic at a reduced config and measures nothing): PipelineRL on
    mamba2-2.7b, the engine serving in plain PyTorch, the Preprocessor's
    forward through the `ssd_scan` kernel, the Trainer differentiating
    the plain chunked SSD, and the streamed broadcast."""
    import dataclasses

    from repro_torch import EngineConfig, PipelineConfig, get_config

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), fused_loss=True,
                              remat=True)
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device)
    ec = EngineConfig(n_slots=16, max_len=512, prefill_chunk=64,
                      temperature=1.0)
    pc = PipelineConfig(batch_size=16, n_opt_steps=3, pack_rows=4,
                        pack_seq=1024, n_engines=1, broadcast="streamed",
                        broadcast_chunks=8)
    p, trainer, pre = _loop_parts(
        cfg, ec, pc, _random_source(np.random.default_rng(0),
                                    cfg.vocab_size), dev)
    eng = p.engine
    rec = _run_loop(p, trainer, pre, dev)
    bad, steps = _loop_checks(rec, p)
    want = _want_launches(cfg, rec, None)
    bad += _launch_checks(cfg, rec, eng, want)
    if not want["ssd_scan"]:
        bad.append(f"no Preprocessor call took the scan kernel: "
                   f"{rec['pre_calls']}")
    batch = rec["seen"][:pc.batch_size]
    check = _preprocess_against_plain(pre, batch)
    if not check["ok"]:
        bad.append(f"Preprocessor kernel against plain: {check}")
    pre_profile = profile = None
    if dev.type == "cuda":
        # one Preprocessor call under the profiler: the device ms of its
        # `ssd_scan` launches (one per layer); one decode step of the
        # running engine
        pre_profile = _profile(lambda: pre.process(
            [dataclasses.replace(r) for r in batch]), dev,
            match={"ssd_scan": "ssd::"})
        profile = _profile(lambda: eng.step(), dev)
    res = _loop_result("ssm", gpu, cfg, ec, pc, rec, steps, p)
    res.update(ssm={"heads": cfg.n_ssm_heads, "head_dim": cfg.ssm_head_dim,
                    "groups": cfg.ssm_n_groups, "state": cfg.ssm_state,
                    "chunk": cfg.ssm_chunk, "d_conv": cfg.d_conv},
               expected_launches=want, preprocess_kernel_vs_plain=check,
               profile=profile, preprocess_profile=pre_profile)
    return _finish("ssm", res, bad)


# ---------------------------------------------------------------------------
# phases 8-9: hybrid (Hymba) and MoE through the PipelineRL loop
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Route the model's attention, SSD scan and fused loss through their
    plain versions, on the card, for one comparison."""
    with plain_attention(), plain_ssd(), plain_fused_loss():
        yield


@contextlib.contextmanager
def moe_range():
    """Mark every MoE layer's call as a profiler range, "moe_apply"."""
    from repro_torch.models import moe
    raw = moe.moe_apply

    def ranged(*a, **k):
        with torch.profiler.record_function("moe_apply"):
            return raw(*a, **k)

    moe.moe_apply = ranged
    try:
        yield
    finally:
        moe.moe_apply = raw


HYBRID_PROFILE = {"flash_decode_paged": DECODE_PAGED,
                  "prefill_attention": "prefill_attention_tc",
                  "flash_attention": "flash_attention_tc",
                  "ssd_scan": "ssd::", "fused_logprob_fwd": "fwd_kernel"}


def phase_hybrid(gpu: str, n_layers: int, device="cuda") -> dict:
    """The hybrid path on `device` (the card; a CPU run rehearses the
    phase's logic at a reduced config and measures nothing): PipelineRL on
    hymba-1.5b, one paged engine (the paged decode kernel, prefix-shared
    GRPO groups whose forks copy the leader's SSM rows), the Preprocessor
    through `flash_attention`, `ssd_scan` and the fused forward, the Trainer
    through the fused loss, and the streamed broadcast."""
    import dataclasses

    from repro_torch import EngineConfig, PipelineConfig, get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("hymba-1.5b"), fused_loss=True,
                              remat=True)
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device)
    ec = EngineConfig(n_slots=16, max_len=512, prefill_chunk=64,
                      cache="paged", page_size=64, paged_attention="kernel",
                      prefix_sharing=True, temperature=1.0)
    pc = PipelineConfig(batch_size=16, n_opt_steps=3, pack_rows=4,
                        pack_seq=1024, n_engines=1, broadcast="streamed",
                        broadcast_chunks=8, group_baseline=True)
    p, trainer, pre = _loop_parts(
        cfg, ec, pc, _grpo_source(np.random.default_rng(0), cfg.vocab_size),
        dev)
    eng = p.engine
    rec = _run_loop(p, trainer, pre, dev)
    bad, steps = _loop_checks(rec, p)
    want = _want_launches(cfg, rec, "flash_decode_paged")
    bad += _launch_checks(cfg, rec, eng, want)
    batch = rec["seen"][:pc.batch_size]
    check = _preprocess_against_plain(pre, batch, faults=_faults(cfg))
    if not check["ok"]:
        bad.append(f"Preprocessor kernels against plain: {check}")
    profile = None
    if dev.type == "cuda":
        admit = torch.zeros(ec.n_slots, dtype=torch.bool, device=dev)
        st = eng.state
        profile = {
            "decode_step": _profile(lambda: eng.step(), dev,
                                    match=HYBRID_PROFILE),
            "prefill_chunk": _profile(lambda: M.prefill_chunk(
                eng.params, st["tokens"], st["prompt_len"], 256, admit,
                st["cache"], cfg, chunk=ec.prefill_chunk,
                block_tables=eng._bt), dev, match=HYBRID_PROFILE),
            "preprocess": _profile(lambda: pre.process(
                [dataclasses.replace(r) for r in batch]), dev,
                match=HYBRID_PROFILE)}
    res = _loop_result("hybrid", gpu, cfg, ec, pc, rec, steps, p)
    res.update(_paged_result(rec, eng))
    bad += _fork_checks(rec, eng)
    # the forks' SSM rows on the card: a paged engine that forks two groups
    # of 8 against a slot engine that prefills all 16 rows, bit for bit
    paged = _paged_against_slots(cfg, trainer.params, dev, ec.n_slots,
                                 group=PIPE_GROUP)
    if not (paged["tokens_equal"] and paged["logprobs_bitwise"]
            and paged["stamps_equal"] and paged["prefix_forks"] > 0):
        bad.append(f"paged against slots: {paged}")
    res.update(ssm={"heads": cfg.n_ssm_heads, "head_dim": cfg.ssm_head_dim,
                    "state": cfg.ssm_state, "chunk": cfg.ssm_chunk},
               expected_launches=want, paged_against_slots=paged,
               preprocess_kernel_vs_plain=check, profile=profile)
    return _finish("hybrid", res, bad)


MOE_PROFILE = {"flash_decode": DECODE_SLOT,
               "prefill_attention": "prefill_attention_tc",
               "flash_attention": "flash_attention_tc",
               "fused_logprob_fwd": "fwd_kernel"}


def phase_moe(gpu: str, n_layers: int, device="cuda") -> dict:
    """The MoE path on `device` (the card; a CPU run rehearses the phase's
    logic at a reduced config and measures nothing): PipelineRL on
    granite-moe-1b-a400m, one slot engine, the Preprocessor and the Trainer
    through the routed experts (the aux loss in every step), the streamed
    broadcast."""
    import dataclasses

    from repro_torch import EngineConfig, PipelineConfig, get_config

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              fused_loss=True, remat=True)
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device)
    ec = EngineConfig(n_slots=16, max_len=512, prefill_chunk=64,
                      temperature=1.0)
    pc = PipelineConfig(batch_size=16, n_opt_steps=3, pack_rows=4,
                        pack_seq=1024, n_engines=1, broadcast="streamed",
                        broadcast_chunks=8)
    p, trainer, pre = _loop_parts(
        cfg, ec, pc, _random_source(np.random.default_rng(0),
                                    cfg.vocab_size), dev)
    eng = p.engine
    rec = _run_loop(p, trainer, pre, dev)
    bad, steps = _loop_checks(rec, p)
    moe_aux = [float(m["moe_aux"]) for m in trainer.history]
    if len(moe_aux) != 3 or not all(np.isfinite(a) and a > 0
                                    for a in moe_aux):
        bad.append(f"moe_aux per step {moe_aux}")
    want = _want_launches(cfg, rec, "flash_decode")
    bad += _launch_checks(cfg, rec, eng, want)
    batch = rec["seen"][:pc.batch_size]
    check = _preprocess_against_plain(pre, batch, faults=_faults(cfg))
    if not check["ok"]:
        bad.append(f"Preprocessor kernels against plain: {check}")
    profile = None
    if dev.type == "cuda":
        # the MoE layers' share of a decode step's and of a Preprocessor
        # call's device time: the kernels launched inside their ranges
        with moe_range():
            profile = {
                "decode_step": _profile(lambda: eng.step(), dev, top=12,
                                        match=MOE_PROFILE,
                                        ranges=("moe_apply",)),
                "preprocess": _profile(lambda: pre.process(
                    [dataclasses.replace(r) for r in batch]), dev, top=12,
                    match=MOE_PROFILE, ranges=("moe_apply",))}
    res = _loop_result("moe", gpu, cfg, ec, pc, rec, steps, p)
    res.update(experts={"n": cfg.n_experts, "top_k": cfg.experts_per_token,
                        "d_ff": cfg.moe_d_ff,
                        "capacity_factor": cfg.capacity_factor},
               moe_aux=moe_aux, expected_launches=want,
               preprocess_kernel_vs_plain=check, profile=profile)
    return _finish("moe", res, bad)


# ---------------------------------------------------------------------------
# phase 10: DeepSeek-V3's latent attention, MoE and MTP head
# ---------------------------------------------------------------------------

MLA_FINISHED = 16         # rollouts the engine serves
MLA_STREAM_AT = 32        # the decode step that starts the streamed swap
MLA_RECOMPUTE_AT = 64     # the decode step of the recompute_kv update
MLA_PRE_ROWS = 8          # rollouts per Preprocessor call: 8 x 512 tokens
MLA_PROFILE = {"prefill_attention": "prefill_attention_wide",
               "fused_logprob_fwd": "fwd_kernel"}


@contextlib.contextmanager
def zeroed_q_rope(rope: int):
    """A control for the prefill chunk's path check: `ops.prefill_attention`
    with the rope part of its query (the last `rope` columns of the
    absorbed q = [q_latent; q_rope]) zeroed in every layer's call."""
    from repro_torch.kernels import ops
    saved = ops.prefill_attention

    def faulty(q, *a, **k):
        q = q.clone()
        q[..., -rope:] = 0
        return saved(q, *a, **k)

    ops.prefill_attention = faulty
    try:
        yield
    finally:
        ops.prefill_attention = saved


def phase_mla(gpu: str, n_layers: int, device="cuda") -> dict:
    """DeepSeek-V3 on `device` (the card; a CPU run rehearses the phase's
    logic at a reduced config and measures nothing): a paged engine with
    prefix-shared GRPO groups admits prompts through the absorbed MLA
    chunk (`prefill_attention`'s wide instance), decodes through the
    absorbed plain attention and the routed experts, takes a streamed swap
    and a `recompute_kv` update, and the Preprocessor scores the finished
    rollouts with the fused forward (main and MTP stats). The launch counts
    are set to 0 before the engine's first refill and read after the last
    Preprocessor call. A train step does not fit one card at these widths
    (the MoE layer's float32 Adam moments alone are 90 GB): the Trainer is
    held on the CPU (tests/test_torch_mla_engine.py)."""
    import dataclasses

    from repro_torch import (EngineConfig, GenerationEngine,
                             PreprocessConfig, Preprocessor, get_config,
                             init_params)
    from repro_torch.core.weights import tree_flatten
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    # published widths; the depth cut to n_layers, of which min(3,
    # n_layers - 1) (at least 1) lead as dense layers, so both kinds run
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(
        full, fused_loss=True, n_layers=n_layers,
        n_dense_layers=max(1, min(full.n_dense_layers, n_layers - 1)))
    reduced = {k: [getattr(full, k), getattr(cfg, k)]
               for k in ("n_layers", "n_dense_layers")
               if getattr(full, k) != getattr(cfg, k)}
    emit({"phase": "mla", "gpu": gpu, "config": cfg.name,
          "reduced": reduced})
    dev = torch.device(device)
    ec = EngineConfig(n_slots=16, max_len=512, prefill_chunk=64,
                      cache="paged", page_size=64, prefix_sharing=True,
                      temperature=1.0)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    update = init_params(cfg, seed=1, device=dev)   # the swapped-in weights
    _sync(dev)
    init_s = time.perf_counter() - t0
    eng = GenerationEngine(
        cfg, params, ec, _grpo_source(np.random.default_rng(0),
                                      cfg.vocab_size), seed=0, device=dev)
    pre = Preprocessor(cfg, update, PreprocessConfig(kl_coef=0.05,
                                                     max_len=ec.max_len),
                       device=dev)
    finished, step_s, chunk_ms, pre_ms = [], [], [], []
    recompute_ms = None
    ops.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_run = time.perf_counter()
    step = 0
    while len(finished) < MLA_FINISHED:
        n_inv = eng.prefill_invocations
        t0 = time.perf_counter()
        eng.refill()
        _sync(dev)
        if eng.prefill_invocations > n_inv:
            chunk_ms.append((time.perf_counter() - t0) * 1e3
                            / (eng.prefill_invocations - n_inv))
        if step == MLA_STREAM_AT:
            eng.begin_weight_stream(update, 1, n_chunks=8)
        if eng.stream_active:
            eng.stream_weight_chunk()
            if not eng.stream_active:
                del params          # the engine holds the update alone
        if step == MLA_RECOMPUTE_AT:
            _sync(dev)
            t0 = time.perf_counter()
            eng.set_weights(update, 2, recompute_kv=True)
            _sync(dev)
            recompute_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        finished += eng.step(now=float(step))
        step_s.append(time.perf_counter() - t0)
        step += 1
    finished = finished[:MLA_FINISHED]
    forks = {"prompt_prefills": eng.prompt_prefills,
             "prefix_forks": eng.prefix_forks,
             "pages_copied": eng.pages_copied,
             "slots_preempted": eng.slots_preempted}
    batches = [finished[i:i + MLA_PRE_ROWS]
               for i in range(0, len(finished), MLA_PRE_ROWS)]
    for batch in batches:
        _sync(dev)
        t0 = time.perf_counter()
        pre.process([dataclasses.replace(r) for r in batch])
        _sync(dev)
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    run_s = time.perf_counter() - t_run
    launches = dict(ops.launches)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)

    bad = []
    if eng.version != 2 or not eng.last_stream_installed:
        bad.append(f"engine version {eng.version}: the streamed swap and "
                   f"the recompute_kv update did not both install")
    if not all((np.diff(r.weight_versions) >= 0).all() for r in finished):
        bad.append("a rollout's version stamps decrease")
    if not all(np.isfinite(r.behavior_logprobs).all()
               and (r.behavior_logprobs[r.prompt_len:] <= 0).all()
               for r in finished):
        bad.append("behavior logprobs not finite and <= 0")
    want = {k: 0 for k in KERNELS}
    want.update(prefill_attention=cfg.n_layers * eng.prefill_invocations,
                fused_logprob_fwd=2 * len(batches))
    bad += [f"{k}: {launches[k]} launches, expected {n}"
            for k, n in want.items() if launches[k] != n]
    if eng.prefix_forks == 0:
        bad.append("no prompt was forked")

    # the kernel path against the plain path on the same state: a prefill
    # chunk's logits (the absorbed attention through prefill_attention,
    # with q_rope zeroed as the control) on the engine's state, writing
    # nothing; the Preprocessor's reference logprobs; the MTP head's
    # logprobs from the fused forward on the first Preprocessor batch
    st, admit = eng.state, torch.zeros(ec.n_slots, dtype=torch.bool,
                                       device=dev)
    off = 4 * ec.prefill_chunk

    def chunk_rows():
        out = M.prefill_chunk(eng.params, st["tokens"], st["prompt_len"], off,
                              admit, st["cache"], cfg,
                              chunk=ec.prefill_chunk, logits=True,
                              block_tables=eng._bt)["logits"]
        return list(out.float().flatten(0, 1).cpu().numpy())

    pre_check = _preprocess_against_plain(pre, batches[0])
    rows = batches[0]
    T = max(r.length for r in rows)
    toks = torch.zeros((len(rows), T), dtype=torch.long, device=dev)
    for i, r in enumerate(rows):
        toks[i, :r.length] = torch.from_numpy(r.tokens.astype(np.int64))
    pos = torch.arange(T, device=dev)[None].expand(len(rows), T)
    tgt = torch.cat([toks[:, 1:], toks[:, -1:]], dim=1)
    aux = []

    def mtp_rows():
        out = M.forward(update, toks, pos, cfg, loss_targets=tgt)
        aux.append(float(out["aux_loss"]))
        lp = out["mtp_token_logprobs"].cpu().numpy()
        # row t scores token t+2: a rollout's rows up to its length - 2
        return [lp[i, :r.length - 2] for i, r in enumerate(rows)]

    with torch.no_grad():
        chunk_check = _path_check(chunk_rows, [
            ("prefill_attention, q_rope zeroed in every layer",
             zeroed_q_rope(cfg.qk_rope_dim), True)])
        mtp_check = _path_check(mtp_rows)
    for name, c in (("prefill chunk", chunk_check),
                    ("Preprocessor", pre_check), ("MTP stats", mtp_check)):
        if not c["ok"]:
            bad.append(f"{name}: kernels against plain {c}")
    if not all(np.isfinite(a) and a > 0 for a in aux):
        bad.append(f"moe_aux {aux}")

    # paged against slots bit for bit with forked rows. A row's MoE output
    # depends on the call's other rows where capacity drops tokens
    # (ROADMAP.md C.9), and a fork's rows hold other values in the paged
    # engine's prefill (it reads the trash page) than in the slot engine's,
    # so the law holds at a capacity that drops nothing (factor E / k: an
    # expert can take every token); at the config's factor 2 it is read
    no_drop = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    paged = _paged_against_slots(no_drop, update, dev, ec.n_slots,
                                 group=PIPE_GROUP)
    if not (paged["tokens_equal"] and paged["logprobs_bitwise"]
            and paged["stamps_equal"] and paged["prefix_forks"] > 0):
        bad.append(f"paged against slots: {paged}")
    paged_cf2 = _paged_against_slots(cfg, update, dev, ec.n_slots,
                                     group=PIPE_GROUP)

    profile = None
    if dev.type == "cuda":
        profile = {
            "decode_step": _profile(lambda: eng.step(), dev,
                                    match=MLA_PROFILE),
            "prefill_chunk": _profile(lambda: M.prefill_chunk(
                eng.params, st["tokens"], st["prompt_len"], off, admit,
                st["cache"], cfg, chunk=ec.prefill_chunk,
                block_tables=eng._bt), dev, match=MLA_PROFILE),
            "preprocess": _profile(lambda: pre.process(
                [dataclasses.replace(r) for r in batches[0]]), dev,
                match=MLA_PROFILE)}
    steady = step_s[1:]
    res = {"phase": "mla", "gpu": gpu, "config": cfg.name,
           "reduced": reduced, "layers": cfg.n_layers,
           "dense_layers": cfg.n_dense_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "vocab": cfg.vocab_size,
           "mla": {"q_lora": cfg.q_lora_rank, "kv_lora": cfg.kv_lora_rank,
                   "nope": cfg.qk_nope_dim, "rope": cfg.qk_rope_dim,
                   "v": cfg.v_head_dim},
           "experts": {"n": cfg.n_experts, "top_k": cfg.experts_per_token,
                       "shared": cfg.n_shared_experts, "d_ff": cfg.moe_d_ff,
                       "dense_d_ff": cfg.dense_d_ff,
                       "capacity_factor": cfg.capacity_factor},
           "mtp_depth": cfg.mtp_depth,
           "params": sum(t.numel() for t in tree_flatten(update)[0]),
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "engine": dataclasses.asdict(ec), "init_s": init_s,
           "run_s": run_s, "rollouts": len(finished),
           "decode_steps": len(step_s),
           "decode_step_ms_median": (statistics.median(steady) * 1e3
                                     if steady else None),
           "prefill_invocations": eng.prefill_invocations,
           "prefill_chunk_ms_median": (statistics.median(chunk_ms)
                                       if chunk_ms else None),
           "preprocess_ms": pre_ms, "recompute_kv_ms": recompute_ms,
           **forks,
           "rollout_versions": sorted({int(v) for r in finished
                                       for v in r.weight_versions[
                                           r.prompt_len:]}),
           "peak_mem_gib": peak, "launches": launches,
           "expected_launches": want, "moe_aux": aux,
           "prefill_chunk_kernel_vs_plain": chunk_check,
           "preprocess_kernel_vs_plain": pre_check,
           "mtp_kernel_vs_plain": mtp_check,
           "paged_against_slots": paged,
           "paged_against_slots_capacity_2": paged_cf2,
           "profile": profile}
    return _finish("mla", res, bad)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 11: the request Server
# ---------------------------------------------------------------------------

SERVER_REQUESTS = 48       # prompts of 256-1000 random ids
SERVER_OVERLONG = (0, 1)   # serving steps at which an over-budget prompt
#                            comes (while slots are free, so the engine
#                            sees it)
SERVER_UPDATES = {"streamed": 32, "quarantine": 48, "atomic": 96}
SERVER_DEADLINE = 160.0    # admission deadline, serving steps
SERVER_MAX_STEPS = 6000


def _percentiles(xs) -> dict:
    return ({"p50": float(np.percentile(xs, 50)),
             "p99": float(np.percentile(xs, 99))} if len(xs) else None)


def phase_server(gpu: str, n_layers: int, device="cuda") -> dict:
    """The request Server (`repro_torch.Server`) on `device` (the card; a
    CPU run rehearses the phase's logic at a reduced config and measures
    nothing): llama3-8b on a paged engine whose pool holds three quarters
    of its slots' full caches, shortest-prompt-first admission with
    deadlines, retries and a queue limit, a streamed and an atomic
    `recompute_kv` weight update under traffic and one quarantined
    request, until every request has settled."""
    import dataclasses

    from repro_torch import EngineConfig, Server, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("llama3-8b")
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device)
    ec = EngineConfig(n_slots=16, max_len=1024, prefill_chunk=128,
                      cache="paged", page_size=64, n_pages=192,
                      paged_attention="kernel", temperature=1.0)
    srv = Server(cfg, M.init_params(cfg, seed=0, device=dev), ec, seed=0,
                 admission="sjf", deadline=SERVER_DEADLINE, max_retries=2,
                 queue_limit=24, device=dev)
    eng = srv.engine
    # update k brings the weights of seed k, stamped version k (the
    # callback holds no reference to the server: no cycle outlives it)
    updates = iter(range(1, 3))

    def trainer_weights():
        k = next(updates)
        return M.init_params(cfg, seed=k, device=dev), k

    srv.connect_trainer(trainer_weights)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(256, 1001, SERVER_REQUESTS)]
    overlong = []

    # every rollout the server completes, the engine's steps timed, the
    # streamed chunks' installs counted
    seen, step_s, chunk_s = [], [], []
    raw_deliver, raw_step = srv.actor.deliver, eng.step
    raw_chunk = eng.stream_weight_chunk

    def kept_deliver(rollouts, t):
        seen.extend(rollouts)
        raw_deliver(rollouts, t)

    def timed_step(*a, **k):
        t0 = time.perf_counter()
        done = raw_step(*a, **k)
        step_s.append(time.perf_counter() - t0)
        return done

    def timed_chunk(*a, **k):
        t0 = time.perf_counter()
        done = raw_chunk(*a, **k)
        chunk_s.append(time.perf_counter() - t0)
        return done

    srv.actor.deliver, eng.step = kept_deliver, timed_step
    eng.stream_weight_chunk = timed_chunk
    ops.reset_launches()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # wall clock of each submission, of the end of the tick that started at
    # a simulated time (a request's first token) and of the tick that ended
    # at one (its completion)
    submitted_wall, first_wall, end_wall, tick_ms = {}, {}, {}, []
    check = quarantined = None
    t_run = time.perf_counter()
    step = 0
    while step <= SERVER_UPDATES["atomic"] or srv.waiting or srv.in_flight \
            or srv._backoff:
        if step < SERVER_REQUESTS // 2:       # two requests a step
            for p in prompts[2 * step:2 * step + 2]:
                submitted_wall[srv.submit(p)] = time.perf_counter()
        if step in SERVER_OVERLONG:
            rid = srv.submit(rng.integers(3, cfg.vocab_size,
                                          ec.max_len + 8).tolist())
            submitted_wall[rid] = time.perf_counter()
            overlong.append(rid)
        if step == SERVER_UPDATES["streamed"]:
            srv.request_weight_update(streamed=True, n_chunks=8)
        if step == SERVER_UPDATES["quarantine"]:
            quarantined = min(srv.in_flight)
            if not srv.quarantine(quarantined, reason="operator"):
                raise SystemExit("server: quarantine refused")
            eng.tables.check()
        if step == SERVER_UPDATES["atomic"]:
            # the kernel path against the plain path on the live state,
            # before the atomic update rewrites the cache
            counted = dict(ops.launches)
            check = _server_path_check(srv, cfg)
            ops.launches.update(counted)    # the comparison's launches
            srv.request_weight_update(recompute_kv=True)
        start = srv.clock
        t0 = time.perf_counter()
        srv.step()
        _sync(dev)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        first_wall[start] = end_wall[srv.clock] = time.perf_counter()
        step += 1
        if step > SERVER_MAX_STEPS:
            raise SystemExit(f"server: not settled after {step} steps: "
                             f"{srv.metrics()}")
    run_s = time.perf_counter() - t_run
    launches = dict(ops.launches)
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 2**30
               if dev.type == "cuda" else None)
    del eng.step, eng.stream_weight_chunk
    srv.actor.deliver = raw_deliver
    m = srv.metrics()

    # --- checks
    bad = []
    n_sub = len(prompts) + len(overlong)
    if m["requests_lost"] != 0:
        bad.append(f"requests_lost {m['requests_lost']}")
    settled = (len(srv.done) + len(srv.rejected) + len(srv.shed)
               + len(srv.quarantined))
    if settled != n_sub:
        bad.append(f"{settled} settled of {n_sub} submitted")
    if sorted(r.rid for r in srv.rejected if r.rid in overlong) != overlong \
            or eng.prompts_rejected != len(overlong):
        bad.append(f"over-budget prompts not rejected: {overlong}")
    if [r.rid for r in srv.quarantined] != [quarantined]:
        bad.append(f"quarantined {[r.rid for r in srv.quarantined]}")
    stamps = set()
    for r in srv.done:
        if (np.diff(r.weight_versions) < 0).any():
            bad.append(f"request {r.rid}: stamps decrease")
        stamps.update(int(v) for v in r.weight_versions)
    if not {0, 1, 2} <= stamps:
        bad.append(f"version stamps {sorted(stamps)}, want 0, 1 and 2")
    if not all(np.isfinite(r.behavior_logprobs).all()
               and (r.behavior_logprobs[r.prompt_len:] <= 0).all()
               for r in seen) or not seen:
        bad.append("behavior logprobs not finite and <= 0")
    if eng.allocator.live_pages != 0:
        bad.append(f"{eng.allocator.live_pages} pages live after the drain")
    if eng.wchunks_rejected or eng.wstreams_torn or eng.version != 2:
        bad.append(f"engine version {eng.version}, rejected "
                   f"{eng.wchunks_rejected}, torn {eng.wstreams_torn}")
    want = {"flash_decode_paged": cfg.n_layers * len(step_s),
            "prefill_attention": cfg.n_layers * eng.prefill_invocations,
            "flash_attention": cfg.n_layers}    # the one recompute_kv
    bad += [f"{k}: {launches[k]} launches, expected {n}"
            for k, n in want.items() if launches[k] != n]
    off_path = [k for k in ("flash_decode", "fused_logprob_fwd",
                            "fused_logprob_bwd", "ssd_scan") if launches[k]]
    if off_path:
        bad.append(f"kernels off the path launched: {off_path}")
    if check is None or not check["decode"]["ok"] \
            or not check["prefill"]["ok"]:
        bad.append(f"kernel path against plain path: {check}")

    ttft = [first_wall[r.admitted_at] - submitted_wall[r.rid]
            for r in srv.done]
    lat = [end_wall[r.finished_at] - submitted_wall[r.rid]
           for r in srv.done]
    install = [tick_ms[i] for i in range(len(tick_ms))
               if SERVER_UPDATES["streamed"] <= i
               < SERVER_UPDATES["streamed"] + 8]
    others = [tick_ms[i] for i in range(SERVER_UPDATES["streamed"] - 8,
                                        SERVER_UPDATES["streamed"])]
    steady = step_s[1:]
    res = {"phase": "server", "gpu": gpu, "config": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "d_head": cfg.d_head,
           "vocab": cfg.vocab_size,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "engine": dataclasses.asdict(ec),
           "prefill_chunk_effective": eng.prefill_chunk_size,
           "server": {"admission": "sjf", "deadline": SERVER_DEADLINE,
                      "max_retries": 2, "queue_limit": 24},
           "submitted": n_sub, "serving_steps": step, "run_s": run_s,
           "metrics": m, "stamps": sorted(stamps),
           "decode_steps": len(step_s),
           "decode_step_ms_median": (statistics.median(steady) * 1e3
                                     if steady else None),
           "decode_tokens_per_s": m["tokens_generated"] / sum(step_s),
           "ttft_ms": _percentiles(np.array(ttft) * 1e3),
           "latency_steps": {"p50": m["p50_latency"],
                             "p99": m["p99_latency"]},
           "latency_ms": _percentiles(np.array(lat) * 1e3),
           "admission_wait_steps_mean": m["mean_admission_wait"],
           "streamed_update": {
               "step_ms_median_during": statistics.median(install),
               "step_ms_median_before": statistics.median(others),
               "chunk_install_ms": [x * 1e3 for x in chunk_s]},
           "pages": {"pool": eng.allocator.n_pages,
                     "slots_preempted": eng.slots_preempted},
           "peak_mem_gib": peak_gb, "launches": launches,
           "expected_launches": want, "path_check": check}
    return _finish("server", res, bad)


def _server_path_check(srv, cfg) -> dict:
    """One decode step and one prefill chunk of the server's live paged
    state through the kernels (the paged decode kernel, the prefill
    kernel) against the same through the plain versions (each slot's
    gathered view, the plain attention), on copies of the page pools;
    logits by `_logits_err`."""
    eng = srv.engine
    st, bt = eng.state, eng._bt
    dev = bt.device
    idx = torch.arange(eng.ec.n_slots, device=dev)
    cur = st["tokens"][idx, st["n_cached"]][:, None]
    pos = st["n_cached"][:, None]
    from repro_torch.models import model as M

    def decode_logits(kernel):
        cache = {k: v.clone() for k, v in st["cache"].items()}
        return M.decode_step(eng.params, cur, pos, cache, st["n_cached"],
                             cfg, ring=False, block_tables=bt,
                             paged_kernel=kernel)["logits"]

    def prefill_logits():
        cache = {k: v.clone() for k, v in st["cache"].items()}
        return M.prefill_chunk(eng.params, st["tokens"], st["prompt_len"],
                               256, st["active"].clone(), cache, cfg,
                               chunk=eng.prefill_chunk_size, logits=True,
                               block_tables=bt)["logits"]

    dec_k = decode_logits(True)
    with plain_attention():
        dec_p = decode_logits(False)
    pre_k = prefill_logits()
    with plain_attention():
        pre_p = prefill_logits()
    return {"active_slots": int(st["active"].sum()),
            "decode": _logits_err(dec_k, dec_p),
            "prefill": _logits_err(pre_k, pre_p)}


# ---------------------------------------------------------------------------
# phase 12: the fault plan through PipelineRL
# ---------------------------------------------------------------------------

FAULTS_STEPS = 4
# when each fault fires, in flashes of the simulated clock (the loop's
# HardwareModel: a decode step of 16 rows on an engine's 2 chips is 512
# flashes, so a wave of rollouts takes ~100,000). Under this plan the
# steps complete at ~143,700, 308,100, 368,800 and 422,600 (the lost one
# at 148,000, the NaN one at 271,800): the trainer crash lands in the
# second step, the preprocessor failure on a batch in flight, the link
# window on the second publication.
FAULT_TIMES = {"engine_crash": 40000.0, "engine_restart_after": 20000.0,
               "trainer_crash": 148000.0, "trainer_restart_after": 5000.0,
               "preprocess_fail": 255000.0, "link": (300000.0, 40000.0),
               "nan_step": 150000.0, "hang": 170000.0,
               "hang_restart_after": 80.0, "poison_ordinal": 5}


def _fault_plan():
    """The faults phase's scripted plan: every fault kind the pipeline
    schedules, at FAULT_TIMES."""
    from repro_torch import FaultPlan
    t = FAULT_TIMES
    at, span = t["link"]
    return (FaultPlan(seed=11)
            .engine_crash(t["engine_crash"], engine=1,
                          restart_after=t["engine_restart_after"])
            .trainer_crash(t["trainer_crash"],
                           restart_after=t["trainer_restart_after"])
            .preprocess_fail(t["preprocess_fail"])
            .degrade_link(at, duration=span, drop_prob=0.3)
            .chunk_corrupt(at, duration=span, drop_prob=0.3)
            .nan_step(t["nan_step"])
            .poison_prompt(t["poison_ordinal"])
            .engine_hang(t["hang"], engine=0,
                         restart_after=t["hang_restart_after"]))


def _faults_run(cfg, dev, plan, ckpt_dir) -> dict:
    """One run of the faults phase's PipelineRL (two paged engines, GRPO
    groups, the Preprocessor, checkpoints every step) under `plan`, with
    the fault firings, every event's simulated time, the checkpoints' and
    the poisoned step's effects, the streamed chunks that reached the
    engines' integrity gate and their installs recorded."""
    import os

    from repro_torch import EngineConfig, PipelineConfig
    from repro_torch.configs.base import HealthConfig
    from repro_torch.core import weights as W

    ec = EngineConfig(n_slots=16, max_len=512, prefill_chunk=64,
                      cache="paged", page_size=64, paged_attention="kernel",
                      prefix_sharing=True, temperature=1.0)
    pc = PipelineConfig(batch_size=16, n_opt_steps=FAULTS_STEPS, pack_rows=4,
                        pack_seq=1024, n_engines=2, broadcast="streamed",
                        broadcast_chunks=8, group_baseline=True,
                        ckpt_every=1, ckpt_dir=ckpt_dir,
                        health=HealthConfig(ckpt_keep=2))
    p, trainer, pre = _loop_parts(
        cfg, ec, pc, _grpo_source(np.random.default_rng(0), cfg.vocab_size),
        dev, fault_plan=plan)
    walls = []
    rec = {"fired": [], "fault_wall": walls, "ckpt": [], "restore": [],
           "poisoned": [], "gate": {"delivered": 0, "corrupt": 0,
                                    "installs": 0, "foreign_installs": 0},
           "chunk_ms": []}
    t0 = [0.0]

    # every event's simulated time
    raw_loop_step = p.loop.step

    def traced_step():
        ok = raw_loop_step()
        if ok:
            rec["fired"].append(p.loop.now)
        return ok

    p.loop.step = traced_step

    # the fault log, stamped with the host clock
    class StampedLog(list):
        def append(self, entry):
            walls.append(time.perf_counter() - t0[0])
            super().append(entry)

    p.fault_log = StampedLog()

    # checkpoint saves and restores, timed, with their files' sizes
    raw_save, raw_restore = trainer.save, trainer.restore

    def timed_save(path):
        _sync(dev)
        t = time.perf_counter()
        out = raw_save(path)
        rec["ckpt"].append({"ms": (time.perf_counter() - t) * 1e3,
                            "bytes": os.path.getsize(out)})
        return out

    def timed_restore(path):
        _sync(dev)
        t = time.perf_counter()
        v = raw_restore(path)
        _sync(dev)
        rec["restore"].append({"ms": (time.perf_counter() - t) * 1e3,
                               "bytes": os.path.getsize(path),
                               "version": v,
                               "durable": p.trainer_stage.last_ckpt_version})
        return v

    # a poisoned step must leave every parameter and moment as it was
    raw_train = trainer.step

    def watched_step(batch, poison=False):
        if not poison:
            return raw_train(batch)
        before = W.tree_flatten(trainer.state)[0]
        m = raw_train(batch, poison=True)
        after = W.tree_flatten(trainer.state)[0]
        rec["poisoned"].append(all(torch.equal(a, b)
                                   for a, b in zip(before, after)))
        return m

    # the integrity gate: each chunk offered to an engine, against the
    # token the engine's own span table gives; each install's leaves must
    # be the published tree's
    def gate(eng):
        raw_begin, raw_chunk = eng.begin_weight_stream, eng.stream_weight_chunk
        published = {}

        def begin(params, version, **k):
            published["leaves"] = W.tree_flatten(params)[0]
            return raw_begin(params, version, **k)

        def chunk(token=None):
            ws = eng._wstream
            if ws is not None and token is not None:
                rec["gate"]["delivered"] += 1
                k = ws["next"]
                rec["gate"]["corrupt"] += token != W.chunk_token(
                    ws["version"], k, ws["sizes"][k])
            t = time.perf_counter()
            done = raw_chunk(token=token)
            rec["chunk_ms"].append((time.perf_counter() - t) * 1e3)
            if done and eng.last_stream_installed:
                rec["gate"]["installs"] += 1
                rec["gate"]["foreign_installs"] += not all(
                    a is b for a, b in zip(W.tree_flatten(eng.params)[0],
                                           published["leaves"]))
            return done

        eng.begin_weight_stream, eng.stream_weight_chunk = begin, chunk

    trainer.save, trainer.restore = timed_save, timed_restore
    trainer.step = watched_step
    for eng in p.engines:
        gate(eng)
    rec["state_bytes"] = W.tree_bytes(trainer.state)
    t0[0] = time.perf_counter()
    run = _run_loop(p, trainer, pre, dev)
    del trainer.save, trainer.restore, p.loop.step
    for eng in p.engines:
        del eng.begin_weight_stream, eng.stream_weight_chunk
    p.fault_log = list(p.fault_log)
    rec.update(run=run, p=p, trainer=trainer, pre=pre, ec=ec, pc=pc)
    return rec


def _schedule_of(rec) -> dict:
    """What two runs of one plan must share: the fault firings, every
    event's simulated time and every counter."""
    p = rec["p"]
    return {"fired": rec["fired"], "fault_log": list(p.fault_log),
            "pool": p.pool_stats(), "broadcast": p.broadcast_stats(),
            "lag": p.lag_stats(),
            "log": [{k: r[k] for k in ("version", "time", "max_lag",
                                       "queue_depth", "bad_step", "samples")}
                    for r in rec["run"]["log"]]}


def phase_faults(gpu: str, n_layers: int, device="cuda") -> dict:
    """The fault plan through the port's PipelineRL on `device` (the card; a
    CPU run rehearses the phase's logic at a reduced config and measures
    nothing): granite-3-2b at full width, its depth cut to `n_layers`, on
    two paged engines, with an engine crash and restart, a trainer crash
    and checkpoint restore, a preprocessor failure, a lossy and corrupting
    link over the second publication, a non-finite step, a poisoned prompt
    and an engine hang healed by the watchdog; the Evaluator before and
    after; then the same plan again, which must take the same course."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from repro_torch import Evaluator, get_config
    from repro_torch.data.math_task import MathTask
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    full = get_config("granite-3-2b")
    cfg = dataclasses.replace(full, fused_loss=True, remat=True,
                              n_layers=n_layers)
    dev = torch.device(device)
    # a checkpoint is the whole TrainState (the params and two float32 Adam
    # moments); the rotation holds `trainer_latest`, two rotated files and
    # the one being written
    state_bytes = cfg.param_count() * (cfg.dtype.itemsize + 8)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(root).free
    if free < 4 * state_bytes:
        shutil.rmtree(root)
        raise SystemExit(f"faults: {free / 2**30:.1f} GiB free under {root}, "
                         f"the checkpoints need {4 * state_bytes / 2**30:.1f}")
    task = MathTask(max_operand=20, ops="+-")
    ev = Evaluator(cfg, task, n_problems=16, max_len=64, device=dev)
    runs = []
    try:
        ops.reset_launches()
        scores = {"before": ev.evaluate(M.init_params(cfg, seed=0,
                                                      device=dev))}
        eval_launches = dict(ops.launches)
        for i in range(2):
            d = os.path.join(root, f"run{i}")
            os.makedirs(d)
            rec = _faults_run(cfg, dev, _fault_plan(), d)
            if i == 0:
                ops.reset_launches()
                scores["after"] = ev.evaluate(rec["trainer"].params)
                for k, n in ops.launches.items():
                    eval_launches[k] += n
                path_check = _preprocess_against_plain(
                    rec["pre"], rec["run"]["seen"][:16], faults=_faults(cfg))
            # keep the host record; the run's tensors go with it
            runs.append({**{k: v for k, v in rec.items()
                            if k not in ("p", "trainer", "pre")},
                         "schedule": _schedule_of(rec),
                         "salvage": _salvage_of(rec["p"]),
                         "engines": [e.version for e in rec["p"].engines]})
            del rec
            shutil.rmtree(d)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return _faults_result(gpu, cfg, full, runs, scores, eval_launches,
                          path_check)


def _salvage_of(p) -> dict:
    """Salvaged prompts against those requeued (still pending or readmitted)
    and quarantined."""
    ps = p.pool_stats()
    pending = sum(getattr(q, "_salvaged_at", None) is not None
                  for q in p.router.pending)
    return {"salvaged": ps["prompts_salvaged"],
            "requeued": ps["prompts_requeued"],
            "readmitted": ps["requeues_readmitted"], "pending": pending,
            "quarantined": ps["prompts_quarantined"],
            "rollouts_lost": ps["rollouts_lost"]}


def _faults_result(gpu, cfg, full, runs, scores, eval_launches,
                   path_check) -> dict:
    import dataclasses
    first, second = runs
    run, sched = first["run"], first["schedule"]
    bad = []
    if not path_check["ok"]:
        bad.append(f"Preprocessor kernels against plain: {path_check}")
    log = run["log"]
    if [r["version"] for r in log if not r["bad_step"]] != \
            list(range(1, FAULTS_STEPS + 1)):
        bad.append(f"optimizer steps {[r['version'] for r in log]}")
    if not all(np.isfinite(r["loss"]) for r in log if not r["bad_step"]):
        bad.append(f"losses {[r['loss'] for r in log]}")
    kinds = [e["kind"] for e in sched["fault_log"]]
    for k in ("engine_crash", "engine_restore", "trainer_crash",
              "trainer_restore", "preprocess_fail", "engine_hang",
              "engine_hang_detected"):
        if k not in kinds:
            bad.append(f"fault log has no {k}: {kinds}")
    sv = first["salvage"]
    if sv["salvaged"] != sv["requeued"] + sv["quarantined"] \
            or sv["requeued"] != sv["readmitted"] + sv["pending"]:
        bad.append(f"salvaged prompts lost: {sv}")
    if sv["quarantined"] < 1:
        bad.append(f"the poisoned prompt was not quarantined: {sv}")
    bc, gate = sched["pool"]["broadcast"], first["gate"]
    if bc["wchunks_rejected"] != gate["corrupt"] or gate["corrupt"] < 1:
        bad.append(f"{bc['wchunks_rejected']} chunks rejected, "
                   f"{gate['corrupt']} corrupt delivered")
    if bc["wstreams_torn"] or gate["foreign_installs"] \
            or bc["chunks_lost"] < 1:
        bad.append(f"broadcast {bc}, gate {gate}")
    if first["poisoned"] != [True]:
        bad.append(f"poisoned steps left the state as it was: "
                   f"{first['poisoned']}")
    restores = [r for r in first["restore"]]
    if not restores or any(r["version"] != r["durable"] for r in restores):
        bad.append(f"restored versions against the checkpoints: {restores}")
    if not all((np.diff(r.weight_versions) >= 0).all() for r in run["seen"]):
        bad.append("a rollout's version stamps decrease")
    if not all(np.isfinite(r.behavior_logprobs).all() for r in run["seen"]):
        bad.append("behavior logprobs not finite")
    for k, v in scores.items():
        if v["n"] != 16 or not all(np.isfinite([v["success_rate"],
                                                v["mean_len"]])):
            bad.append(f"Evaluator {k}: {v}")
    if eval_launches["flash_decode"] < 1:
        bad.append("the Evaluator did not launch flash_decode")
    want = {"flash_decode_paged": cfg.n_layers * len(run["step_s"]),
            "flash_attention": cfg.n_layers * len(run["pre_calls"]),
            "fused_logprob_fwd": len(run["pre_calls"]) + len(run["train"]),
            "fused_logprob_bwd": len(run["train"])}
    bad += [f"{k}: {run['launches'][k]} launches, expected {n}"
            for k, n in want.items() if run["launches"][k] != n]
    if run["launches"]["ssd_scan"] or run["launches"]["flash_decode"]:
        bad.append(f"kernels off the path launched: {run['launches']}")
    # the replay: the same schedule and counters; sampled tokens and losses
    # are read
    replay = {k: second["schedule"][k] == v for k, v in sched.items()}
    if not all(replay.values()):
        bad.append(f"the replay took another course: {replay}")
    a, b = run["seen"], second["run"]["seen"]
    diff_tokens = sum(int((x.tokens != y.tokens).sum()) for x, y in zip(a, b)
                      if x.tokens.shape == y.tokens.shape)
    losses = [(r["version"], r["loss"], q["loss"])
              for r, q in zip(log, second["run"]["log"])
              if r["loss"] != q["loss"]]
    wall = [dict(e, wall_s=w) for e, w in zip(sched["fault_log"],
                                              first["fault_wall"])]
    steps = [{"version": r["version"], "bad_step": r["bad_step"],
              "sim_time": r["time"], "wall_s": w["at_s"],
              "train_ms": w["train_ms"], "loss": r["loss"]}
             for r, w in zip(log, run["train"])]
    res = {"phase": "faults", "gpu": gpu, "config": cfg.name,
           "layers": cfg.n_layers,
           "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
           "params": cfg.param_count(), "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "d_head": cfg.d_head,
           "vocab": cfg.vocab_size,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "engine": dataclasses.asdict(first["ec"]),
           "pipeline": {k: v for k, v in dataclasses.asdict(
               first["pc"]).items() if k not in ("health", "ckpt_dir")},
           "plan": repr(_fault_plan()),
           "run_s": run["run_s"], "opt_steps": steps,
           "decode_steps": len(run["step_s"]),
           "decode_step_ms_median": statistics.median(run["step_s"]) * 1e3,
           "generated_tokens_per_s": run["tokens"] / sum(run["step_s"]),
           "faults": wall, "salvage": sv, "gate": gate,
           "broadcast": sched["broadcast"], "pool": sched["pool"],
           "checkpoint": {"state_bytes": first["state_bytes"],
                          "saves": first["ckpt"],
                          "restores": first["restore"]},
           "stream_chunk_install_ms_median": statistics.median(
               first["chunk_ms"]) if first["chunk_ms"] else None,
           "poisoned_steps_bitwise": first["poisoned"],
           "evaluator": scores, "evaluator_launches": eval_launches,
           "preprocess_kernel_vs_plain": path_check,
           "replay": {"same": replay,
                      "sampled_tokens_differing": diff_tokens,
                      "rollouts": [len(a), len(b)],
                      "losses_differing": losses},
           "peak_mem_gib": run["peak_mem_gib"], "launches": run["launches"],
           "expected_launches": want}
    return _finish("faults", res, bad)


# ---------------------------------------------------------------------------
# phase 13: the dry-run (meta DTensors on a fake process group; no device)
# ---------------------------------------------------------------------------

DRYRUN_COMBOS = (("granite-3-2b", "train_4k"), ("granite-3-2b", "decode_32k"),
                 ("deepseek-v3-671b", "decode_32k"))
DRYRUN_TIMEOUT_S = 900


def _dryrun_worker(out_path: str) -> int:
    """`chip_smoke.py --dryrun-worker OUT`: the dry-run's records, one JSON
    object per line: the combos on the (16, 8) mesh with the weight update
    whole and in 3 chunks, the disaggregated split, and a one-device trace
    of the train phase's own step (granite-3-2b, 4 x 1024, fused loss,
    remat). It runs on the host's CPU and touches no device."""
    import dataclasses

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import run_disaggregated, run_one
    from repro_torch.launch.mesh import fake_world
    from repro_torch.roofline.analysis import model_flops_estimate

    with open(out_path, "w") as f:
        def put(rec):
            if rec.get("ok"):
                rec.pop("traceback", None)
            f.write(json.dumps(rec, default=str) + "\n")
            f.flush()

        for arch, shape in DRYRUN_COMBOS:
            put(dict(run_one(arch, shape, include_weight_update=True,
                             wu_chunks=3), kind="combo"))
        put(dict(run_disaggregated("granite-3-2b"), kind="disaggregated"))
        fake_world(1)
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(get_config("granite-3-2b"), fused_loss=True,
                                  remat=True)
        shape = ShapeSpec("train_phase", 1024, 4, "train")
        t0 = time.time()
        prog = steps.lower_program(cfg, shape, mesh)
        put({"kind": "train_step", "ok": True, "flops": prog.flops,
             "bytes": prog.bytes, "n_ops": prog.n_ops,
             "model_flops": model_flops_estimate(cfg, shape),
             "t_trace_s": time.time() - t0})
    return 0


def start_dryrun(out_path: str):
    """Start the dry-run worker on the host's CPU; it runs beside the GPU
    phases and `phase_dryrun` collects it."""
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    err = open(out_path + ".err", "w")
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun-worker", out_path], env=env,
                            stdout=subprocess.DEVNULL, stderr=err)


def phase_dryrun(gpu: str, proc, out_path: str, train_res) -> dict:
    """The dry-run's records: each combo's three roofline terms on H100
    data-sheet constants (arithmetic, not timings), bottleneck, collective
    bytes by kind and axis, trace time; the weight update whole and per
    chunk; the disaggregated split; the one-device FLOP count of the train
    phase's step beside that phase's measured step median."""
    t0 = time.time()
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SystemExit("dryrun: the worker did not finish in "
                         f"{DRYRUN_TIMEOUT_S} s")
    waited = time.time() - t0
    recs = [json.loads(l) for l in Path(out_path).read_text().splitlines()
            if l.strip()]
    bad = [] if rc == 0 else [f"worker exit code {rc}: " + Path(
        out_path + ".err").read_text()[-2000:]]
    rows = []
    for r in recs:
        if not r.get("ok"):
            bad.append(f"{r.get('arch')}/{r.get('shape', r['kind'])}: "
                       f"{r.get('error')}")
            continue
        if r["kind"] == "combo":
            ch = r["weight_update_chunks"]
            rows.append({k: r[k] for k in (
                "arch", "shape", "mesh", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "traced_gflops_per_dev",
                "traced_gbytes_per_dev", "coll_gbytes_per_dev",
                "coll_breakdown", "coll_axis", "useful_flops_ratio",
                "memory_analysis", "t_trace_s", "n_ops")})
            rows[-1]["weight_update"] = {
                "t_collective_s": r["weight_update"]["t_collective_s"],
                "coll_breakdown": r["weight_update"]["coll_breakdown"],
                "n_chunks": ch["n_chunks"],
                "sum_t_collective_s": ch["sum_t_collective_s"],
                "max_chunk_t_collective_s": ch["max_chunk_t_collective_s"]}
        elif r["kind"] == "disaggregated":
            rows.append({"disaggregated": r["arch"],
                         "train_mesh": r["train_mesh"],
                         "gen_mesh": r["gen_mesh"],
                         "train": {k: r["train"][k] for k in (
                             "t_compute_s", "t_memory_s", "t_collective_s",
                             "bottleneck")},
                         "serve": {k: r["serve"][k] for k in (
                             "t_compute_s", "t_memory_s", "t_collective_s",
                             "bottleneck")},
                         "t_total_s": r["t_total_s"]})
        else:
            step = {k: r[k] for k in ("flops", "bytes", "model_flops",
                                      "t_trace_s", "n_ops")}
            if train_res:
                med_s = train_res["step_ms_median"] / 1e3
                peak = PEAK_FLOPS[torch.bfloat16]
                step.update(
                    train_step_ms_median=train_res["step_ms_median"],
                    traced_flops_share=r["flops"] / (med_s * peak),
                    model_flops_share=r["model_flops"] / (med_s * peak))
            rows.append({"train_step_one_device": step})
    if len(recs) != len(DRYRUN_COMBOS) + 2:
        bad.append(f"{len(recs)} records, expected {len(DRYRUN_COMBOS) + 2}")
    res = {"phase": "dryrun", "gpu": gpu, "records": rows,
           "waited_s": waited,
           "note": "terms are arithmetic on H100 SXM data-sheet constants "
                   "(989e12 bf16 FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s NVLink "
                   "on 'model', 50e9 B/s on 'data'/'pod'), not timings"}
    return _finish("dryrun", res, bad)


# ---------------------------------------------------------------------------
# phase 14: the vocab-parallel loss and expert-parallel MoE, two gloo ranks
# on cuda:0
# ---------------------------------------------------------------------------

SHARDED_LOSS = dict(N=4096, D=4096, V=128256)    # llama3-8b's head
SHARDED_TOKENS = (4, 1024)                       # the MoE layer's tokens


def _events_ms(fn, iters: int, device: str = "cuda") -> float:
    """Median wall ms of fn() between synchronizations (two ranks share
    the card, so each rank's time includes the other's overlap)."""
    out = []
    for _ in range(iters):
        _sync(torch.device(device))
        t0 = time.perf_counter()
        fn()
        _sync(torch.device(device))
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _sharded_rank(rank: int, port: int, out_dir: str, device: str,
                  loss_shape: dict, tokens: tuple) -> None:
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sharded import fused_logprob_sharded
    from repro_torch.models import moe as TMoE
    from repro_torch.shardctx import sharding_context

    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    res: dict = {"rank": rank}
    try:
        mesh = DeviceMesh(device, torch.arange(2), mesh_dim_names=("model",))
        N, D, V = (loss_shape[k] for k in ("N", "D", "V"))
        vl = V // 2
        gen = torch.Generator(device=device).manual_seed(11)
        h = torch.randn((N, D), generator=gen, device=device).bfloat16()
        w = (torch.randn((D, V), generator=gen, device=device)
             * D ** -0.5).bfloat16()
        t = torch.randint(0, V, (N,), generator=gen, device=device)
        g = torch.randn((3, N), generator=gen, device=device)
        cols = slice(rank * vl, (rank + 1) * vl)

        def sharded():
            hl = h.clone().requires_grad_(True)
            wl = w[:, cols].contiguous().requires_grad_(True)
            hd = DTensor.from_local(hl, mesh, [Replicate()], run_check=False)
            wd = DTensor.from_local(wl, mesh, [Shard(1)], run_check=False)
            td = DTensor.from_local(t, mesh, [Replicate()], run_check=False)
            out = fused_logprob_sharded(hd, wd, td, mesh=mesh)
            vals = [o.to_local() for o in out]
            torch.autograd.backward(vals, list(g))
            return [v.detach() for v in vals], hl.grad, wl.grad

        def one_rank():
            hl = h.clone().requires_grad_(True)
            wl = w.clone().requires_grad_(True)
            vals = ops.fused_logprob(hl, wl, t)
            torch.autograd.backward(vals, list(g))
            return [v.detach() for v in vals], hl.grad, wl.grad[:, cols]

        ops.reset_launches()
        vals, dh, dw = sharded()
        _sync(torch.device(device))
        res["launches"] = dict(ops.launches)
        v1, dh1, dw1 = one_rank()
        pv = ref.fused_logprob_blocked(h, w, t)
        pdh, pdw = ref.blocked_backward(h, w, t, pv[1], pv[2], *g,
                                        transpose_head=False)
        pdw = pdw[:, cols]

        def err(a, b):
            return float((a.float() - b.float()).abs().max())

        def rel(a, b):
            return err(a, b) / max(float(b.float().abs().max()), 1e-30)

        res["loss"] = {
            "shape": dict(N=N, D=D, V=V, per_rank=vl), "dtype": "bfloat16",
            "vs_one_rank": {"values_max_abs": max(err(a, b) for a, b in
                                                  zip(vals, v1)),
                            "dh_rel": rel(dh, dh1), "dw_rel": rel(dw, dw1)},
            "vs_plain": {"values_max_abs": max(err(a, b) for a, b in
                                               zip(vals, pv)),
                         "dh_rel": rel(dh, pdh), "dw_rel": rel(dw, pdw)},
            "finite": all(bool(torch.isfinite(x).all())
                          for x in (*vals, dh, dw)),
            "sharded_ms": _events_ms(sharded, 3, device),
            "one_rank_ms": _events_ms(one_rank, 3, device)}
        del w, pv, pdh, pdw, dw1, v1, dh1
        if device == "cuda":
            torch.cuda.empty_cache()

        cfg = get_config("granite-moe-1b-a400m")
        d, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        gen = torch.Generator(device=device).manual_seed(12)
        wts = {"router": torch.randn((d, E), generator=gen, device=device)
               * d ** -0.5}
        for k, shp in (("gate", (E, d, Fd)), ("up", (E, d, Fd)),
                       ("down", (E, Fd, d))):
            wts[k] = (torch.randn(shp, generator=gen, device=device)
                      * shp[1] ** -0.5).bfloat16()
        x = torch.randn(tuple(tokens) + (d,), generator=gen,
                        device=device).bfloat16()

        def ep():
            dwts = {k: DTensor.from_local(v, mesh, [Replicate()],
                                          run_check=False)
                    for k, v in wts.items()}
            dx = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
            with torch.no_grad(), sharding_context(mesh):
                o, a = TMoE.moe_apply(dwts, dx, cfg)
            return o.to_local(), a.to_local()

        def single():
            with torch.no_grad():
                return TMoE.moe_apply(wts, x, cfg)

        o, a = ep()
        o1, a1 = single()
        T = x.shape[0] * x.shape[1]
        C = TMoE._capacity(T, cfg)
        probs = torch.softmax(x.reshape(T, d).float() @ wts["router"], -1)
        d_ep, _ = TMoE.route(probs, cfg, C, E // 2, rank * (E // 2))
        d_all, _ = TMoE.route(probs, cfg, C, E, 0)
        same = True
        for de, da in zip(d_ep, d_all):
            mine = (da != E * C) & (da // C >= rank * (E // 2)) & \
                (da // C < (rank + 1) * (E // 2))
            same &= bool(torch.equal(de[mine], da[mine] - rank * (E // 2) * C))
            same &= bool((de[~mine] == (E // 2) * C).all())
        res["moe"] = {"shape": dict(T=T, d=d, E=E, k=cfg.experts_per_token,
                                    d_ff=Fd, capacity=C, per_rank=E // 2),
                      "dtype": "bfloat16",
                      "out_rel": rel(o, o1), "aux_abs": err(a, a1),
                      "decisions_equal": same,
                      "finite": bool(torch.isfinite(o.float()).all()),
                      "ep_ms": _events_ms(ep, 3, device),
                      "single_ms": _events_ms(single, 3, device)}
    except Exception as e:  # reported by the parent, which fails the phase
        res["error"] = f"{type(e).__name__}: {e}"
    finally:
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def phase_sharded(gpu: str, device="cuda", loss_shape=SHARDED_LOSS,
                  tokens=SHARDED_TOKENS) -> dict:
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one card): the
    vocab-parallel fused loss at llama3-8b's head in bfloat16, forward and
    backward, each rank launching the fused kernels on its 64128 vocab
    columns, held against the one-rank kernel path and the plain version
    (2e-2); granite-moe-1b-a400m's MoE layer at its published widths,
    expert-parallel over the two ranks, against the unsharded port path.
    A CPU run (`device="cpu"`, smaller shapes) rehearses the phase's logic
    and measures nothing."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="sharded_")
    t0 = time.time()
    mp.spawn(_sharded_rank, args=(port, out_dir, device, dict(loss_shape),
                                  tuple(tokens)), nprocs=2, join=True)
    ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
             for r in range(2)]
    bad = []
    for r in ranks:
        if "error" in r:
            bad.append(f"rank {r['rank']}: {r['error']}")
            continue
        ls, mo = r["loss"], r["moe"]
        for k in ("fused_logprob_fwd", "fused_logprob_bwd"):
            if device == "cuda" and r["launches"].get(k, 0) < 1:
                bad.append(f"rank {r['rank']} launched no {k}")
        for ref_name in ("vs_one_rank", "vs_plain"):
            e = ls[ref_name]
            if not (e["values_max_abs"] <= 2e-2 and e["dh_rel"] <= 2e-2
                    and e["dw_rel"] <= 2e-2):
                bad.append(f"rank {r['rank']} loss {ref_name}: {e}")
        if not ls["finite"] or not mo["finite"]:
            bad.append(f"rank {r['rank']}: non-finite output")
        if not (mo["out_rel"] <= 2e-2 and mo["aux_abs"] <= 1e-5
                and mo["decisions_equal"]):
            bad.append(f"rank {r['rank']} moe: out_rel {mo['out_rel']}, "
                       f"aux {mo['aux_abs']}, decisions "
                       f"{mo['decisions_equal']}")
    res = {"phase": "sharded", "gpu": gpu, "ranks": ranks,
           "wall_s": time.time() - t0,
           "launches": ranks[0].get("launches", {}),
           "launches_per_rank": [r.get("launches") for r in ranks]}
    return _finish("sharded", res, bad)


# ---------------------------------------------------------------------------
# phase 15: the executed multi-rank runtime, four gloo ranks on one card
# ---------------------------------------------------------------------------

MESH_WORLD = 4
MESH_STEPS = 20            # decode steps of the engine check
MESH_CHUNKS = 8            # the pipeline's streamed broadcast


def _mesh_digest(rollouts) -> str:
    import hashlib
    h = hashlib.sha256()
    for r in rollouts:
        h.update(np.asarray(r.tokens).tobytes())
        h.update(np.asarray(r.weight_versions).tobytes())
    return h.hexdigest()


def _mesh_engine_check(cfg, sub, rank, dev) -> dict:
    """A slot engine on a 2-rank submesh (default rules: heads split, the
    cache split along `cache_seq`) against the one-rank engine, token for
    token over MESH_STEPS decode steps, in float32: the tensor-parallel
    partial sums differ from the one-device products by ~1e-7, far below
    any sampling margin, where bfloat16 differs by an ulp (0.4%) and flips
    near-ties. Then the bfloat16 engine, with the default rules and with
    the cache split by KV heads (`cache_seq` replicated: no gather), timed
    per decode step; how far its tokens follow the one-rank engine's is
    reported, not held."""
    import dataclasses

    from repro_torch import EngineConfig, GenerationEngine
    from repro_torch.models import model as M
    from repro_torch.shardctx import STAGED

    ec = EngineConfig(n_slots=16, max_len=512, prefill_chunk=64,
                      temperature=1.0)
    out = {}
    for name, dtype, rules in (("float32", torch.float32, None),
                               ("bfloat16", torch.bfloat16, None),
                               ("bfloat16_no_gather", torch.bfloat16,
                                {"cache_seq": None})):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = M.init_params(c, seed=0, device=dev)

        def source():
            return _random_source(np.random.default_rng(1), c.vocab_size)

        eng = GenerationEngine(c, params, ec, source(), seed=3, device=dev,
                               mesh=sub, rules=rules)
        ref = (GenerationEngine(c, params, ec, source(), seed=3, device=dev)
               if rank == 0 and name != "bfloat16_no_gather" else None)
        del params
        rec = {"step_ms": [], "ref_step_ms": [], "first_difference": None,
               "rollouts": []}
        eng.refill()
        if ref is not None:
            ref.refill()
        g0, l0 = dict(STAGED), dict(eng.lockstep)
        for i in range(MESH_STEPS):
            _sync(dev)
            t0 = time.perf_counter()
            rec["rollouts"] += eng.step()
            _sync(dev)
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if ref is not None:
                gstate = ref.generator.get_state()
                t0 = time.perf_counter()
                logits = _ref_step_logits(ref)
                _sync(dev)
                rec["ref_step_ms"].append((time.perf_counter() - t0) * 1e3)
                bad = torch.nonzero(eng.state["tokens"] != ref.state["tokens"])
                if len(bad) and rec["first_difference"] is None:
                    s, t = (int(v) for v in bad[0])
                    rec["first_difference"] = dict(
                        step=i, slot=s, position=t,
                        mesh=int(eng.state["tokens"][s, t]),
                        one_rank=int(ref.state["tokens"][s, t]),
                        mesh_lp=float(eng.state["lp"][s, t]),
                        one_rank_lp=float(ref.state["lp"][s, t]),
                        **_score_margin(logits, gstate, s,
                                        int(ref.state["tokens"][s, t]),
                                        int(eng.state["tokens"][s, t]),
                                        float(eng.state["lp"][s, t]),
                                        ec.temperature))
        if ref is not None:
            # over the sampled positions only (the prompts are shared)
            pos = torch.arange(ec.max_len, device=dev)[None]
            plen = torch.as_tensor(ref._host_prompt_len, device=dev)[:, None]
            ncached = torch.as_tensor(ref._host_ncached, device=dev)[:, None]
            sampled = (pos >= plen) & (pos <= ncached)
            same = (eng.state["tokens"] == ref.state["tokens"]) & sampled
            rec["sampled_tokens"] = int(sampled.sum())
            rec["tokens_equal_share"] = float(same.sum() / sampled.sum())
        rec["steps"] = MESH_STEPS
        rec["gathers_per_step"] = (STAGED["gathers"] - g0["gathers"]) \
            / MESH_STEPS
        rec["gather_bytes_per_step"] = (STAGED["bytes"] - g0["bytes"]) \
            / MESH_STEPS
        rec["broadcasts_per_step"] = (eng.lockstep["broadcasts"]
                                      - l0["broadcasts"]) / MESH_STEPS
        rec["broadcast_bytes_per_step"] = (eng.lockstep["bytes"]
                                           - l0["bytes"]) / MESH_STEPS
        rec["step_ms_median"] = statistics.median(rec["step_ms"])
        if rec["ref_step_ms"]:
            rec["ref_step_ms_median"] = statistics.median(rec["ref_step_ms"])
        rec["cache_placements"] = (str(eng.state["cache"]["k"].placements)
                                   if eng._runs else None)
        rec["rollouts"] = _mesh_digest(rec["rollouts"])
        if name == "bfloat16":
            out["_engine"] = eng       # the co-sim runs on it
        out[name] = rec
        del eng, ref
    return out


def _ref_step_logits(ref) -> torch.Tensor:
    """`ref.step()` on the one-rank engine, returning the (H, V) logits
    its decode step sampled from."""
    from repro_torch.models import model as M
    raw, seen = M.decode_step, {}

    def decode_step(*a, **k):
        out = raw(*a, **k)
        seen["logits"] = out["logits"][:, 0]
        return out

    M.decode_step = decode_step
    try:
        ref.step()
    finally:
        M.decode_step = raw
    return seen["logits"]


def _score_margin(logits, gstate, slot: int, a: int, b: int,
                  mesh_lp: float, temperature: float) -> dict:
    """The one-rank engine's Gumbel-max scores of its token `a` and of the
    mesh engine's token `b` in row `slot` at the step where they first
    differ: the draws are those of the generator state `gstate` the step
    began with (one seed, so the same draws in both engines), the
    logprobs as `core/rollout._engine_step` takes them. `score_margin` is
    how far `a` won there; `lp_shift` is the mesh engine's logprob of `b`
    less the one-rank engine's."""
    g = torch.Generator(device=logits.device)
    g.set_state(gstate)
    u = torch.rand(logits.shape, generator=g, device=logits.device)[slot]
    gumbel = -torch.log(-torch.log(u))
    logp = torch.log_softmax((logits / max(temperature, 1e-6)).float(),
                             dim=-1)[slot]
    score = logp + gumbel
    return {"one_rank_lp_of_mesh_token": float(logp[b]),
            "gumbel": [float(gumbel[a]), float(gumbel[b])],
            "score_margin": float(score[a] - score[b]),
            "lp_shift": mesh_lp - float(logp[b])}


def _mesh_cosim(eng, cfg, dev) -> dict:
    """`record_cosim_trace` on the bfloat16 mesh engine (a publication every
    8 ticks in 4 chunks, placed on the engine's submesh and measured), then
    `replay_trace` through the EventLoop twin."""
    from repro_torch.core.weights import tree_flatten, tree_unflatten
    from repro_torch.launch.meshrt import record_cosim_trace, replay_trace
    from repro_torch.models import model as M

    params = M.init_params(cfg, seed=5, device=dev)
    leaves, treedef = tree_flatten(params)
    trace = record_cosim_trace(eng, tree_unflatten(treedef, leaves),
                               n_ticks=24, publish_every=8, n_chunks=4)
    rep = replay_trace(trace)
    rep.pop("versions_sim")
    return {"replay": rep,
            "chunk_s": [t["chunk_s"] for t in trace["ticks"]
                        if t["chunk_s"] is not None],
            "decode_s_median": statistics.median(
                t["decode_s"] for t in trace["ticks"])}


def _mesh_pipeline(cfg, world, rank, dev) -> dict:
    """PipelineRL on the mesh: the trainer on all four ranks, two paged
    engines on 2-rank submeshes (the pipeline phase's engine: chunk 64,
    page 64, prefix-shared GRPO groups), 3 optimizer steps, a streamed
    broadcast in MESH_CHUNKS chunks through `MeshBroadcastExecutor`. The
    trainer's whole parameters are kept at every version, so each engine
    is held bit for bit to the version it holds."""
    import dataclasses

    from repro_torch import (AdamConfig, EngineConfig, HardwareModel,
                             PipelineConfig, PipelineRL, Trainer)
    from repro_torch.core.weights import (chunk_spans, span_bytes,
                                          tree_bytes, tree_flatten)
    from repro_torch.data.math_task import MathTask
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.shardctx import STAGED, full

    # the pipeline phase's engine with max_len 192 and prompts of 96-160
    # ids: completions of 32-96 tokens, fewer decode steps and prefill
    # chunks of a host-staged engine
    ec = EngineConfig(n_slots=16, max_len=192, prefill_chunk=64,
                      cache="paged", page_size=64, paged_attention="kernel",
                      prefix_sharing=True, temperature=1.0)
    pc = PipelineConfig(batch_size=16, n_opt_steps=3, pack_rows=4,
                        pack_seq=1024, n_engines=2, broadcast="streamed",
                        broadcast_chunks=MESH_CHUNKS, group_baseline=True)
    params = M.init_params(cfg, seed=0, device=dev)
    trainer = Trainer(cfg, params, adam=AdamConfig(lr=1e-3), device=dev,
                      mesh=world)
    base = HardwareModel()
    per_chip = ec.n_slots / (pc.n_chips - pc.train_chips)
    hw = dataclasses.replace(base, bcast_bytes_per_flash=tree_bytes(params)
                             / (PIPE_BCAST_STEPS * base.step_cost(per_chip)))
    p = PipelineRL(cfg, params, MathTask(), ec, pc, hw=hw, trainer=trainer,
                   prompt_source=_grpo_source(np.random.default_rng(0),
                                              cfg.vocab_size, (96, 160)),
                   device=dev, mesh=world)
    del params

    def whole(tree):
        return [full(x).clone() for x in tree_flatten(tree)[0]]

    snaps = {0: whole(trainer.params)}
    rec = {"train_ms": [], "step_ms": {}, "refill_ms": {}}
    seen = []
    raw_train = trainer.step

    def train_step(*a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        m = raw_train(*a, **k)
        _sync(dev)
        rec["train_ms"].append((time.perf_counter() - t0) * 1e3)
        snaps[trainer.version] = whole(trainer.params)
        return m

    def wrap(i, eng):
        raw_step, raw_refill = eng.step, eng.refill
        rec["step_ms"][i], rec["refill_ms"][i] = [], []

        def step(*a, **k):
            t0 = time.perf_counter()
            done = raw_step(*a, **k)
            _sync(dev)
            rec["step_ms"][i].append((time.perf_counter() - t0) * 1e3)
            seen.extend(done)
            return done

        def refill(*a, **k):
            t0 = time.perf_counter()
            n = raw_refill(*a, **k)
            _sync(dev)
            rec["refill_ms"][i].append((time.perf_counter() - t0) * 1e3)
            return n

        eng.step, eng.refill = step, refill

    trainer.step = train_step
    for i, eng in enumerate(p.engines):
        wrap(i, eng)
    fired, raw_loop_step = [], p.loop.step

    def loop_step():
        ok = raw_loop_step()
        if ok:
            fired.append(p.loop.now)
        return ok

    p.loop.step = loop_step
    g0 = dict(STAGED)
    ops.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    log = p.run()
    _sync(dev)
    run_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    for eng in p.engines:
        del eng.step, eng.refill
    del trainer.step, p.loop.step
    engines = []
    for i, eng in enumerate(p.engines):
        ranks = [int(r) for r in eng.mesh.mesh.reshape(-1)]
        params_equal = None
        if eng._runs:
            mine = whole(eng.params)
            params_equal = all(torch.equal(a, b) for a, b in
                               zip(mine, snaps[eng.version]))
            del mine
        engines.append({
            "ranks": ranks, "runs": eng._runs, "version": eng.version,
            "params_equal_trainer_version": params_equal,
            "steps": len(rec["step_ms"][i]),
            "prefill_invocations": eng.prefill_invocations,
            "prompt_prefills": eng.prompt_prefills,
            "prefix_forks": eng.prefix_forks,
            "lockstep": dict(eng.lockstep),
            "broadcasts_per_step": (eng.lockstep["broadcasts"]
                                    / max(len(rec["step_ms"][i]), 1)),
            "step_ms_median": (statistics.median(rec["step_ms"][i])
                               if rec["step_ms"][i] else None),
            "refill_ms_total": sum(rec["refill_ms"][i]),
            "tokens_generated": eng.tokens_generated})
    bs = p.broadcast_stats()
    sizes = span_bytes(tree_flatten(trainer.params)[0],
                       chunk_spans(tree_flatten(trainer.params)[0],
                                   MESH_CHUNKS))
    stamps_ok = all((np.diff(r.weight_versions) >= 0).all()
                    and int(r.weight_versions.max()) <= trainer.version
                    for r in seen)
    res = {"log": [{k: (float(v) if isinstance(v, (float, np.floating))
                        else v) for k, v in r.items()} for r in log],
           "fired": fired, "rollouts": len(seen),
           "stream": _mesh_digest(seen), "stamps_ok": stamps_ok,
           "trainer_version": trainer.version,
           "devices": [list(a.devices) for a in p.actors],
           "engines": engines, "launches": launches, "run_s": run_s,
           "train_ms": rec["train_ms"],
           "broadcast": {k: v for k, v in bs.items() if k != "engines"},
           "exec_records": [{"engine": r["engine"], "version": r["version"],
                             "nbytes": r["nbytes"], "seconds": r["seconds"],
                             "per_chunk": r["per_chunk"]}
                            for r in p.broadcaster.exec_records],
           "chunk_bytes": sizes,
           "loss_route": _loss_route(cfg, world),
           "gathers": STAGED["gathers"] - g0["gathers"],
           "gather_bytes": STAGED["bytes"] - g0["bytes"],
           "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else None)}
    del snaps
    return res


def _loss_route(cfg, mesh) -> str:
    """Which fused-loss route the mesh trainer takes: vocab-parallel when
    the head's vocab divides the axis its rule names, else the whole head
    on every rank (`kernels/sharded.py`)."""
    from repro_torch.kernels.sharded import vocab_shard_count
    from repro_torch.sharding import DEFAULT_RULES
    key = "p_embed_vocab" if cfg.tie_embeddings else "p_vocab"
    n = vocab_shard_count(mesh, DEFAULT_RULES[key], cfg.vocab_size)
    if n > 1:
        return f"vocab-parallel over {n} shards of {cfg.vocab_size // n}"
    return (f"replicated head: vocab {cfg.vocab_size} does not divide "
            f"{mesh.size()} ranks, each runs the whole fused loss")


def _mesh_weight_update(cfg, dev) -> dict:
    """`execute_weight_update` on the four ranks as a (2, 2) ("data",
    "model") mesh: the trainer layout (FSDP over "data", tensor parallel
    over "model") to the generation layout, in MESH_CHUNKS chunks."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.steps import execute_weight_update

    mesh = DeviceMesh(dev.type, torch.arange(MESH_WORLD).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    recs = execute_weight_update(cfg, mesh, n_chunks=MESH_CHUNKS,
                                 max_bytes=16 << 30)
    return {"chunks": recs,
            "sum_t_exec_s": sum(r["t_exec_s"] for r in recs),
            "nbytes": sum(r["nbytes"] for r in recs)}


def _mesh_rank(rank: int, port: int, out_dir: str, device: str,
               n_layers: int, overrides: dict) -> None:
    import dataclasses
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import get_config
    from repro_torch.launch.mesh import engine_submeshes

    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=MESH_WORLD,
                            timeout=datetime.timedelta(minutes=10))
    dev = torch.device(device)
    res: dict = {"rank": rank}
    try:
        cfg = dataclasses.replace(get_config("granite-3-2b"),
                                  fused_loss=True, remat=True,
                                  n_layers=n_layers, **overrides)
        world = DeviceMesh(device, torch.arange(MESH_WORLD),
                           mesh_dim_names=("model",))
        subs = engine_submeshes(world, 2)
        eng = _mesh_engine_check(cfg, subs[0], rank, dev)
        res["cosim"] = _mesh_cosim(eng.pop("_engine"), cfg, dev)
        res["engine"] = eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res["pipeline"] = _mesh_pipeline(cfg, world, rank, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res["weight_update"] = _mesh_weight_update(cfg, dev)
        res["peak_mem_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                               if dev.type == "cuda" else None)
    except Exception as e:  # reported by the parent, which fails the phase
        res["error"] = f"{type(e).__name__}: {e}"
        res["traceback"] = traceback.format_exc()[-3000:]
    finally:
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(res, f, default=_plain)
        dist.destroy_process_group()


def _plain(x):
    """numpy scalars and tuples for `json.dump`."""
    return x.item() if hasattr(x, "item") else str(x)


def _mesh_update_model(cfg) -> list:
    """The dry-run's per-chunk `t_collective_s` of the same weight update:
    the step traced on meta tensors over a fake process group of four
    ranks as the (2, 2) mesh, in this process (the group is destroyed
    after)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _mesh, fake_world
    from repro_torch.launch.steps import lower_weight_update
    from repro_torch.roofline.analysis import analyze

    fake_world(MESH_WORLD)
    try:
        mesh = _mesh(torch.arange(MESH_WORLD).reshape(2, 2),
                     ("data", "model"))
        return [analyze(p.name, p, MESH_WORLD).row()["t_collective_s"]
                for p in lower_weight_update(cfg, mesh, MESH_CHUNKS)]
    finally:
        dist.destroy_process_group()


def _mesh_checks(ranks, n_layers: int, device, n_spans: int,
                 n_bytes: int) -> list:
    """Every check of the mesh phase over the ranks' results; the weight
    update must come in `n_spans` chunks of `n_bytes` in all."""
    bad = []
    for r in ranks:
        if "error" in r:
            bad.append(f"rank {r['rank']}: {r['error']}\n{r['traceback']}")
    if bad:
        return bad
    first = ranks[0]
    e32 = first["engine"]["float32"]
    if e32["first_difference"] is not None:
        bad.append(f"float32 mesh engine tokens differ from the one-rank "
                   f"engine's: {e32['first_difference']}")
    for r in ranks:
        k = r["rank"]
        for name in ("float32", "bfloat16", "bfloat16_no_gather"):
            if r["engine"][name]["rollouts"] != \
                    first["engine"][name]["rollouts"]:
                bad.append(f"rank {k}: {name} engine rollouts differ "
                           f"from rank 0's")
        rep = r["cosim"]["replay"]
        rel = abs(rep["sim_total_s"] - rep["measured_total_s"]) \
            / max(rep["measured_total_s"], 1e-12)
        prel = abs(rep["sim_pause_per_update"]
                   - rep["measured_pause_per_update"]) \
            / max(rep["measured_pause_per_update"], 1e-12)
        if not (rel < 0.05 and prel <= 0.05
                and rep["updates_sim"] == rep["updates_measured"] == 2
                and abs(rep["mean_lag_sim"] - rep["mean_lag_measured"])
                <= 0.5 and rep["sim_pause_per_update"] > 0):
            bad.append(f"rank {k} co-sim: {rep}")
        p = r["pipeline"]
        for key in ("log", "fired", "stream", "rollouts", "trainer_version",
                    "devices"):
            if p[key] != first["pipeline"][key]:
                bad.append(f"rank {k}: pipeline {key} differs from rank 0's")
        if [e["lockstep"] for e in p["engines"]] != \
                [e["lockstep"] for e in first["pipeline"]["engines"]]:
            bad.append(f"rank {k}: lockstep counts differ from rank 0's")
        if [x["version"] for x in p["log"]] != [1, 2, 3] \
                or p["trainer_version"] != 3 \
                or not all(np.isfinite(x["loss"]) for x in p["log"]):
            bad.append(f"rank {k}: optimizer steps {p['log']}")
        if p["broadcast"]["executed"] < 1:
            bad.append(f"rank {k}: no executed publication")
        if not p["stamps_ok"]:
            bad.append(f"rank {k}: version stamps decrease or run ahead")
        if set(p["devices"][0]) & set(p["devices"][1]):
            bad.append(f"rank {k}: the actors' ranks overlap")
        mine = [e for e in p["engines"] if e["runs"]]
        if [e["ranks"] for e in mine] != [[0, 1] if k < 2 else [2, 3]]:
            bad.append(f"rank {k} runs engines {mine}")
        for e in mine:
            if e["version"] < 1 or not e["params_equal_trainer_version"]:
                bad.append(f"rank {k}: engine on {e['ranks']} at version "
                           f"{e['version']} does not hold the trainer's "
                           f"parameters of that version bit for bit")
            want = {"flash_decode_paged": n_layers * e["steps"],
                    "prefill_attention": n_layers
                    * e["prefill_invocations"],
                    "fused_logprob_fwd": 3, "fused_logprob_bwd": 3,
                    "flash_decode": 0, "flash_attention": 0, "ssd_scan": 0}
            if device == "cuda" and p["launches"] != want:
                bad.append(f"rank {k} launches {p['launches']}, "
                           f"expected {want}")
        wu = r["weight_update"]
        if len(wu["chunks"]) != n_spans or wu["nbytes"] != n_bytes \
                or not all(c["t_exec_s"] > 0 for c in wu["chunks"]):
            bad.append(f"rank {k}: weight update {wu}, expected {n_spans} "
                       f"chunks of {n_bytes} bytes in all")
    return bad


def phase_mesh(gpu: str, n_layers: int, device="cuda",
               overrides=None) -> dict:
    """The executed multi-rank runtime: four gloo ranks on cuda:0 (NCCL
    refuses two ranks on one card; gloo stages each collective through
    host memory, and its gathers take the process group's all-gather,
    `shardctx.redistribute`), granite-3-2b at published widths in bfloat16
    cut to `n_layers`: the engine check, `PipelineRL(mesh=)` on two paged
    engines, the co-sim and `execute_weight_update` beside the dry-run's
    `t_collective_s`. A CPU run (`device="cpu"` with `overrides` making the
    config small) rehearses the phase's logic and measures nothing."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="mesh_")
    overrides = dict(overrides or {})
    emit({"phase": "mesh", "gpu": gpu, "note": "granite-3-2b cut",
          "n_layers": n_layers, "published_layers": 40,
          "overrides": {k: str(v) for k, v in overrides.items()}})
    t0 = time.time()
    mp.spawn(_mesh_rank, args=(port, out_dir, device, n_layers, overrides),
             nprocs=MESH_WORLD, join=True)
    wall = time.time() - t0
    ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
             for r in range(MESH_WORLD)]
    import dataclasses

    from repro_torch import get_config
    from repro_torch.core.weights import chunk_spans, tree_flatten
    from repro_torch.launch.steps import abstract_params
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=n_layers,
                              **overrides)
    model_t = _mesh_update_model(cfg)
    leaves = [a.value for a in tree_flatten(abstract_params(cfg))[0]]
    bad = _mesh_checks(ranks, n_layers, device,
                       len(chunk_spans(leaves, MESH_CHUNKS)),
                       sum(x.numel() * x.element_size() for x in leaves))
    first = ranks[0]
    res = {"phase": "mesh", "gpu": gpu, "wall_s": wall,
           "n_layers": n_layers, "world": MESH_WORLD,
           "gather_route": "c10d all_gather_into_tensor on gloo (host "
                           "staged); DTensor's functional all-gather "
                           "crashes on CUDA tensors",
           "launches": first.get("pipeline", {}).get("launches", {}),
           "launches_per_rank": [r.get("pipeline", {}).get("launches")
                                 for r in ranks],
           "weight_update_model_t_collective_s": model_t,
           "ranks": [{k: v for k, v in r.items()
                      if k not in ("traceback",)} for r in ranks]}
    for r in res["ranks"]:
        p = r.get("pipeline")
        if p:
            p["log_len"] = len(p.pop("log"))
            p["fired_len"] = len(p.pop("fired"))
    return _finish("mesh", res, bad)


# ---------------------------------------------------------------------------
# phase 16: the launch CLI on the card
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--steps", "4", "--fused-loss", "--max-len", "64",
               "--kl-coef", "0.05"]


def phase_launch(gpu: str, device="cuda") -> dict:
    """`repro_torch.launch.train.main` on the card: the tiny pipeline for 4
    steps with the fused loss, max_len 64 and the reference KL. Its step
    lines, the kernels it launched and how often, finite rewards and
    losses."""
    import io
    import math
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import train as TT

    log = Path(tempfile.mkdtemp(prefix="launch_")) / "log.json"
    buf = io.StringIO()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        TT.main(LAUNCH_ARGS + ["--log-out", str(log), "--device", device])
    _sync(torch.device(device))
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    lines = [l for l in buf.getvalue().splitlines() if l]
    steps = [l for l in lines if l.startswith("step ")]
    recs = json.loads(log.read_text())
    bad = []
    if len(steps) != 4 or len(recs) != 4:
        bad.append(f"{len(steps)} step lines, {len(recs)} log records")
    if not all(math.isfinite(r["reward"]) and math.isfinite(r["loss"])
               for r in recs):
        bad.append("a non-finite reward or loss")
    for k in ("fused_logprob_fwd", "fused_logprob_bwd"):
        if device == "cuda" and launches.get(k, 0) < 1:
            bad.append(f"no {k} launch")
    idle = [k for k in ("flash_decode", "prefill_attention",
                        "flash_attention") if not launches.get(k)]
    res = {"phase": "launch", "gpu": gpu, "argv": LAUNCH_ARGS,
           "lines": lines, "launches": launches, "wall_s": wall,
           "attention_kernels_not_engaged": idle}
    return _finish("launch", res, bad)


def summary(kernels: list, paths: dict, gpu: str) -> list:
    """One entry per kernel: its case at the main path's shapes in bfloat16
    and its launches on the path that runs it (the serve phase for the slot
    attention kernels, the train phase for the fused loss, the pipeline
    phase for the paged decode, the ssm phase for the SSD scan). `paths`
    maps a phase to its result."""
    out = []
    for name, (source, replaces, main_label, home) in KERNELS.items():
        rows = [r for r in kernels if r["name"] == name]
        main_row = next((r for r in rows if r["label"] == main_label
                         and r["dtype"] == "bfloat16"), None)
        by_phase = {ph: res["launches"][name]
                    for ph, res in paths.items() if res}
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": by_phase.get(home),
                 "launches_by_phase": by_phase, "gpu": gpu}
        if main_row is not None:
            entry.update(
                core=main_row["route"],
                max_abs_err=main_row["max_err"], ms=main_row["kernel_ms"],
                plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"],
                bound_by=main_row["bound_by"],
                bound_share=main_row["bound_ms"] / main_row["kernel_ms"],
                library_ms=main_row["library_ms"], shape=main_row["shape"],
                dtype=main_row["dtype"], tol=main_row["tol"])
            if "yardstick_ms" in main_row:
                entry.update(yardstick_ms=main_row["yardstick_ms"],
                             yardstick=main_row["yardstick"])
        entry["cases"] = [{k: r[k] for k in ("label", "dtype", "route",
                                             "max_err",
                                             "err_measure", "err_value",
                                             "tol", "bitwise_vs_flash_decode",
                                             "ok") if k in r}
                          for r in rows]
        out.append(entry)
    return out


def release_memory(after: str, gpu: str) -> None:
    """Return the dropped path's cached blocks to the card and report what
    is still allocated, and the seconds since the script started (so
    consecutive lines give each phase's wall time). No garbage collection: a path's objects are freed
    by reference counting when its phase returns (a `PipelineRL` holds no
    reference cycle), so what remains allocated is what is still live."""
    torch.cuda.empty_cache()
    emit({"phase": "release", "after": after, "gpu": gpu,
          "memory_allocated": torch.cuda.memory_allocated(),
          "memory_reserved": torch.cuda.memory_reserved(),
          "at_s": time.perf_counter() - T_START})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dryrun-worker"]:
        return _dryrun_worker(argv[1])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run")
    ap.add_argument("--layers", type=int, default=32,
                    help="llama3-8b depth in the serve phase")
    ap.add_argument("--train-layers", type=int, default=40,
                    help="granite-3-2b depth in the train phase")
    ap.add_argument("--pipeline-layers", type=int, default=40,
                    help="granite-3-2b depth in the pipeline phase")
    ap.add_argument("--ssm-layers", type=int, default=64,
                    help="mamba2-2.7b depth in the ssm phase")
    ap.add_argument("--hybrid-layers", type=int, default=32,
                    help="hymba-1.5b depth in the hybrid phase")
    ap.add_argument("--moe-layers", type=int, default=24,
                    help="granite-moe-1b-a400m depth in the moe phase")
    ap.add_argument("--mla-layers", type=int, default=2,
                    help="deepseek-v3-671b depth in the mla phase (61 "
                         "published; 2 run one dense and one MoE layer)")
    ap.add_argument("--server-layers", type=int, default=32,
                    help="llama3-8b depth in the server phase")
    ap.add_argument("--mesh-layers", type=int, default=4,
                    help="granite-3-2b depth in the mesh phase (40 "
                         "published)")
    ap.add_argument("--faults-layers", type=int, default=2,
                    help="granite-3-2b depth in the faults phase (40 "
                         "published; a checkpoint of 2 layers is ~3.2 GB)")
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
    dry = None
    if "dryrun" in phases:
        # the dry-run needs no device: it runs on the host beside the GPU
        # phases and is collected after them
        import tempfile
        dry_out = str(Path(tempfile.mkdtemp(prefix="dryrun_")) / "dry.jsonl")
        dry = start_dryrun(dry_out)
    try:
        return _run_phases(args, phases, gpu, dry,
                           dry_out if dry is not None else None)
    finally:
        if dry is not None and dry.poll() is None:
            dry.kill()
            dry.wait()


def _run_phases(args, phases, gpu, dry, dry_out) -> int:
    kernels, paths = [], {}
    if "env" in phases:
        phase_env(gpu)
    if "build" in phases:
        phase_build(gpu)
    if "kernels" in phases:
        kernels = phase_kernels(gpu)
        kernels += phase_fused(gpu, (torch.float32, torch.bfloat16))
        kernels += phase_ssd(gpu)
        release_memory("kernels", gpu)
    # each path runs with the launch counts set to 0 just before it and
    # read just after (the phases reset and report them); a path's device
    # memory is freed when its phase returns
    if "serve" in phases:
        paths["serve"] = phase_serve(gpu, args.layers)
        release_memory("serve", gpu)
    if "train" in phases:
        paths["train"] = phase_train(gpu, args.train_layers)
        release_memory("train", gpu)
    if "pipeline" in phases:
        paths["pipeline"] = phase_pipeline(gpu, args.pipeline_layers)
        release_memory("pipeline", gpu)
    if "ssm" in phases:
        paths["ssm"] = phase_ssm(gpu, args.ssm_layers)
        release_memory("ssm", gpu)
    if "hybrid" in phases:
        paths["hybrid"] = phase_hybrid(gpu, args.hybrid_layers)
        release_memory("hybrid", gpu)
    if "moe" in phases:
        paths["moe"] = phase_moe(gpu, args.moe_layers)
        release_memory("moe", gpu)
    if "mla" in phases:
        paths["mla"] = phase_mla(gpu, args.mla_layers)
        release_memory("mla", gpu)
    if "server" in phases:
        paths["server"] = phase_server(gpu, args.server_layers)
        release_memory("server", gpu)
    if "faults" in phases:
        paths["faults"] = phase_faults(gpu, args.faults_layers)
        release_memory("faults", gpu)
    if "sharded" in phases:
        paths["sharded"] = phase_sharded(gpu)
        release_memory("sharded", gpu)
    if "mesh" in phases:
        paths["mesh"] = phase_mesh(gpu, args.mesh_layers)
        release_memory("mesh", gpu)
    if "launch" in phases:
        paths["launch"] = phase_launch(gpu)
        release_memory("launch", gpu)
    if dry is not None:
        phase_dryrun(gpu, dry, dry_out, paths.get("train"))

    emit({"kernels": summary(kernels, paths, gpu)})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
