"""Run one cell once as `run.py` runs it, with the program's own recorder
switched apart from the trace, and summarise what the program's spans and
counters say:

    python3 rlbench/trace_program.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--recorder <0|1>]

The run goes through `run.py`'s set-up (`run.context`) and
`program.run_driver`: with `--recorder 1` (the default) the port's
recorder (`repro_torch.trace`) is on for the whole run and, with `--trace
1`, the engine's counters are sampled after every decode step and the
device's busy intervals and kernel starts of the profiled window kept
(`rlbench/program.py`), as in every `run.py --trace 1` run. The last line
of standard output is one JSON result: `correct`, the cell's metrics (the
end-to-end ones with `--trace 0`, the per-layer ones with `--trace 1`,
`run.read_metrics`) and, under `program`, the decode step's split, the idle
time of the card by innermost span, the traced window's counters and the
alignment of the trace's clock. `--trace 0 --recorder 0` is `run.py`'s
untraced run; `--trace 1 --recorder 0` is a traced run without the
recorder, and beside `--recorder 1` it costs the recorder.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rlbench import flops, program  # noqa: E402
from rlbench import run as bench  # noqa: E402


def program_summary(rec) -> dict:
    """What the program's spans and counters say about the traced window."""
    p = rec["program"]
    leads = [1e6 * x for x in program.kernel_leads(p)]
    slacks = [1e6 * x for x in program.wait_slacks(p)]
    out = {"step_ms": program.step_split(p),
           "kernel_lead_us": {"max": max(leads), "first": leads[0],
                              "last": leads[-1], "steps": len(leads)}
           if leads else None,
           "wait_slack_us": {"min": min(slacks), "max": max(slacks)}
           if slacks else None, "aligned": program.aligned(p),
           **{k: p.get(k) for k in ("anchors", "wander_us", "drift_ppm",
                                    "mark_offset_us")},
           "idle_s": None,
           "spans_in_window": len([s for s in p["spans"]
                                   if p["t_lo"] <= s[1] < p["t_hi"]])}
    if p["busy"] is not None:
        idle = program.idle_by_span(p["busy"], p["spans"], p["t_lo"],
                                    p["t_hi"])
        out["idle_s"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
        out["traced_s"] = p["t_hi"] - p["t_lo"]
    got = program.counter_delta(p)
    if got:
        out["counters"], out["steps"] = got
    # the prefill arithmetic of the window's admitted leaders, from the
    # prefill spans' fields
    useful = rows = 0
    for i in program.in_window(p, "engine.refill.prefill"):
        f = p["spans"][i][4]
        useful += sum(max(n - 1, 0) for n in f["leaders"])
        rows += f["rows"] * f["chunks"] * rec["traffic"]["engine"][
            "prefill_chunk"]
    out["prefill_from_leaders"] = {"useful": useful, "row_tokens": rows}
    # the engine's own step span against the benchmark's wrapper around it
    steps = [s for s in p["spans"] if s[0] == "engine.step"
             and rec["t_open"] <= s[1] and s[2] <= rec["t_close"]]
    if steps:
        out["window_step_ms"] = 1e3 * sum(s[2] - s[1] for s in steps) / len(
            steps)
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    bench._setup_env()
    bj = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench.cell_of(bj, args.workload)
    if not bench.needs_cards(cell):
        return 2

    import torch
    ctx, driver, limits = bench.context(cell, args.seed, args.seconds,
                                        bool(args.trace), t_start=T_START)
    rec = program.run_driver(driver, ctx, bool(args.recorder))
    torch.cuda.synchronize()
    metrics = bench.read_metrics(
        bj, cell, rec, "per_layer" if args.trace else "end_to_end")
    correct, shown = bench.judge(rec["checks"], limits)
    out = {"workload": cell["name"], "seed": args.seed,
           "trace": args.trace, "recorder": args.recorder,
           "correct": bool(correct), "checks": shown, "metrics": metrics,
           "window": {k: rec["window"][k] for k in
                      ("seconds", "sampled_tokens", "prefill_tokens",
                       "batches")},
           "device": torch.cuda.get_device_name(0),
           "power_limit": flops.card_power_limit()}
    if args.recorder:
        out["program"] = program_summary(rec)
    if args.trace and rec.get("traced"):
        out["breakdown"] = bench.breakdown(rec["traced"])
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
