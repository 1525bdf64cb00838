"""Hold the engine's `blocking_transfers` counter against PyTorch's own
detector of synchronizing CUDA calls, over a few refills and decode steps
of a paged engine on the card:

    python3 scripts/check_blocking_transfers.py [--config granite-3-2b] \
        [--layers 4] [--ticks 24]

Each tick is a refill and a decode step. It runs under
`torch.cuda.set_sync_debug_mode("warn")`, which warns once for each call
that makes the host wait for the card; the tick's warnings, by source
line, are set beside the counter's change. The prompts are GRPO groups of
8 whose lengths make the ticks pass every site: admissions with prefill
and forks, copy-on-write copies, block-table syncs and finished rows.
Prints one JSON line per tick and a summary as the last line. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def prompts(vocab: int, max_len: int, group: int = 8):
    """GRPO groups whose completions end within a few steps (prompts just
    under max_len) between groups that keep their slots, so that the
    same ticks admit, fork and finish."""
    lens = [max_len - 6, 130, max_len - 9, 200, max_len - 4, 140,
            max_len - 12, 260] * 8
    for g, n in enumerate(lens):
        ids = [3 + (g * 7919 + i * 104729) % (vocab - 3) for i in range(n)]
        for _ in range(group):
            yield ids


def where(filename: str) -> str:
    """A source file by its path in the repository, else in full."""
    path = Path(filename).resolve()
    return str(path.relative_to(ROOT)) if path.is_relative_to(ROOT) \
        else str(path)


def check(cfg, params, ec, ticks: int, device) -> dict:
    import torch
    from repro_torch.core.rollout import GenerationEngine
    from repro_torch.data.math_task import Problem

    it = prompts(cfg.vocab_size, ec.max_len)
    eng = GenerationEngine(cfg, params, ec,
                           lambda: Problem(list(next(it)), 0), seed=7,
                           device=device)
    for _ in range(3):                 # warm: kernels loaded, shapes seen
        eng.refill()
        eng.step()
    rows, total = [], Counter()
    for t in range(ticks):
        n0 = eng.blocking_transfers
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                admitted = eng.refill()
                done = eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = Counter(f"{where(w.filename)}:{w.lineno}" for w in got
                        if "synchroniz" in str(w.message))
        n = eng.blocking_transfers - n0
        total.update(sites)
        rows.append({"tick": t, "admitted": admitted, "finished": len(done),
                     "counter": n, "warnings": sum(sites.values()),
                     "sites": dict(sites)})
        print(json.dumps(rows[-1]), flush=True)
    agree = sum(r["counter"] == r["warnings"] for r in rows)
    return {"ticks": len(rows), "ticks_agreeing": agree,
            "counter_total": sum(r["counter"] for r in rows),
            "warnings_total": sum(r["warnings"] for r in rows),
            "ticks_admitting": sum(bool(r["admitted"]) for r in rows),
            "ticks_finishing": sum(bool(r["finished"]) for r in rows),
            "sites": dict(total)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="granite-3-2b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=24)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("check_blocking_transfers: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import get_config
    from repro_torch.core.rollout import EngineConfig
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    build.build(["paged_decode", "prefill_attention"])
    cfg = dataclasses.replace(get_config(args.config), n_layers=args.layers)
    params = init_params(cfg, seed=0, device="cuda")
    # the engine of the rollout cell (rlbench/traffic/rollout-grpo512.json)
    ec = EngineConfig(n_slots=256, max_len=512, prefill_chunk=64,
                      cache="paged", page_size=64, paged_attention="kernel",
                      prefix_sharing=True, temperature=1.0, eos_id=-1)
    out = check(cfg, params, ec, args.ticks, "cuda")
    out.update(device=torch.cuda.get_device_name(0), config=args.config,
               layers=args.layers)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
