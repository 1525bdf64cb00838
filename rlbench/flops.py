"""The benchmark's frozen arithmetic: parameter counts, model FLOPs, the
bytes and operations of the kernels whose roofline shares it reports, and
the peaks of one NVIDIA H100 SXM.

Everything here is computed from a configuration file's sizes and from
shapes the benchmark records; nothing is read from the program. Later
changes to the program do not move these numbers.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Iterable, Sequence

from rlbench import arch

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP32 = 67e12            # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def card_power_limit() -> str:
    """The card's power limit as nvidia-smi reports it ("700.00 W"), or
    "unknown"; the peaks above hold at 700 W."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unknown"


def param_count(c: Dict, active_only: bool = False) -> int:
    """Parameters of the embedding, the head and the layers (`c` is a
    configuration file): the architecture's frozen copy of the port's
    analytic count (`rlbench/arch/<model_type>.py`). `active_only` counts
    the experts a token uses."""
    return arch.of(c).param_count(c, active_only)


def active_params_no_embed(c: Dict) -> int:
    """N_active of the model-FLOP count: the active parameters less the
    input embedding (a lookup, no multiply)."""
    return (param_count(c, active_only=True)
            - c["vocab_size"] * c["hidden_size"])


def model_flops(n_active: int, trained_tokens: float,
                forward_tokens: float) -> float:
    """6 N per trained token (forward and backward) plus 2 N per token that
    only goes forward (sampled, prefilled, scored by the Preprocessor).
    Attention's context FLOPs and the recompute of activation
    checkpointing are not counted."""
    return 6.0 * n_active * trained_tokens + 2.0 * n_active * forward_tokens


def mfu_percent(flops: float, seconds: float) -> float:
    return 100.0 * flops / (seconds * PEAK_FLOPS_BF16)


def bound_seconds(nbytes: float, flops: float,
                  peak_flops: float = PEAK_FLOPS_BF16) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def paged_decode_launch(n_rows: int, q_heads: int, kv_heads: int,
                        head_dim: int, n_blocks: int, valid_kv: int,
                        keys: int, elt: int = BF16_BYTES) -> Dict[str, float]:
    """One `flash_decode_paged` launch over `n_rows` rows: q and out read
    and written once, each valid cached (page, offset) read once (a page
    that forked rows share counts once), the block table and the lengths
    (int32). Operations: QK^T and PV of every query head over each row's
    keys (`keys` summed over the rows), 4 keys H D."""
    nbytes = ((2 * n_rows * q_heads * head_dim
               + 2 * valid_kv * kv_heads * head_dim) * elt
              + 4 * (n_rows * n_blocks + n_rows))
    return {"bytes": float(nbytes),
            "flops": 4.0 * keys * q_heads * head_dim}


def paged_valid_keys(table: Sequence[Sequence[int]],
                     lengths: Iterable[int], page_size: int) -> int:
    """Distinct valid (page, offset) pairs read by one decode step: for each
    row of length n, its first ceil(n / page_size) blocks; a page shared
    by several rows counts its largest valid prefix once."""
    best: Dict[int, int] = {}
    for row, n in zip(table, lengths):
        n = int(n)
        for j in range(-(-n // page_size)):
            page = int(row[j])
            best[page] = max(best.get(page, 0),
                             min(page_size, n - j * page_size))
    return sum(best.values())


def fused_loss_fwd(n: int, d: int, v: int,
                   elt: int = BF16_BYTES) -> Dict[str, float]:
    """The fused lm-head forward on (N, D) rows and a (D, V) head: the
    logits product (2 N D V); hidden, head and targets read once, three
    float32 outputs written once."""
    return {"flops": 2.0 * n * d * v,
            "bytes": float((n * d + d * v) * elt + 4 * n + 12 * n)}


def fused_loss_bwd(n: int, d: int, v: int,
                   elt: int = BF16_BYTES) -> Dict[str, float]:
    """Its backward: the logits recomputed, then the dh and dW products
    (3 x 2 N D V); the forward's inputs, four float32 row vectors, and dh
    and dW written once."""
    return {"flops": 6.0 * n * d * v,
            "bytes": float((n * d + d * v) * elt + 4 * n + 16 * n
                           + (n + v) * d * elt)}
