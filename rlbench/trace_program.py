"""Run one cell once with the program's own recorder, and read the
program's spans and counters beside the benchmark's metrics:

    python3 rlbench/trace_program.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--recorder <0|1>]

The cell runs through its driver as `run.py` runs it. With `--recorder 1`
(the default) the port's recorder (`repro_torch.trace`) is on for the
whole run and the engine's counters are sampled after every decode step;
with `--trace 1` the device's busy intervals and kernel starts of the
profiled window are kept too (`rlbench/program.py`). The last line of
standard output is one JSON result: `correct`, the cell's metrics (the
end-to-end ones with `--trace 0`, the per-layer ones with `--trace 1`)
and, under `program`, the metrics of the program's own spans and counters
(`PROGRAM_METRICS`, read by `rlbench/metrics/<name>.py`), the decode
step's split, the idle time of the card by innermost span, the traced
window's counters and the alignment of the trace's clock. `--trace 0
--recorder 0` is `run.py`'s untraced run; `--recorder 1` beside it costs
the recorder.

The driver builds the engine and opens the profiled window itself; this
script sees both by standing in for `repro_torch.GenerationEngine` (a
subclass that samples the counters after each step) and for
`harness.profile_summary` (which also keeps the device's activity).
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

from rlbench import flops, harness, program, rehearse  # noqa: E402
from rlbench import run as bench  # noqa: E402

PROGRAM_METRICS = ("engine.step.host_ms", "device.idle.enqueue",
                   "device.idle.step_host", "engine.prefill_useful_share",
                   "engine.blocking_transfers_per_step")


def run_recorded(driver, ctx, recorder: bool = True):
    """`driver.run(ctx)` with the recorder on (or not); the record gains
    `program` (module docstring of `rlbench/program.py`)."""
    import repro_torch
    from repro_torch import trace
    clock = ctx["clock"]
    samples, seen = [], {}

    def make_engine(Engine):
        class Sampled(Engine):
            def step(self, *a, **k):
                out = super().step(*a, **k)
                c = program.counters(self)
                if c is not None:
                    samples.append((time.perf_counter(), c))
                return out
        return Sampled

    def make_start(start):
        def profile_start():
            prof, t_mark = start()
            seen["ends"] = [program.end_mark()]
            return prof, t_mark
        return profile_start

    def make_summary(summary):
        def profile_summary(prof, t_mark, clock_, t_lo, t_hi, spans):
            seen["ends"].append(program.end_mark())
            out = summary(prof, t_mark, clock_, t_lo, t_hi, spans)
            seen.update(acts=harness._kernels(prof), t_mark=t_mark,
                        t_hi=t_hi)
            return out
        return profile_summary

    with rehearse.patched(repro_torch, "GenerationEngine", make_engine), \
            rehearse.patched(harness, "profile_start", make_start), \
            rehearse.patched(harness, "profile_summary", make_summary):
        if recorder:
            trace.take()
            trace.enable()
        try:
            rec = driver.run(ctx)
        finally:
            if recorder:
                trace.disable()
    records = trace.take() if recorder else []
    p = {"spans": program.on_window(records, clock),
         "counters": [(clock.window_of(t), c) for t, c in samples],
         "busy": None, "kernel_starts": None, "t_lo": rec["t_open"],
         "t_hi": seen.get("t_hi", rec["t_close"])}
    if "acts" in seen:
        p.update(program.device_activity(
            seen["acts"], seen["ends"], program.sync_points(records), clock,
            p["t_lo"], p["t_hi"], seen["t_mark"]))
    rec["program"] = p
    return rec


def program_summary(rec) -> dict:
    """What the program's spans and counters say about the traced window."""
    p = rec["program"]
    metrics = {}
    for name in PROGRAM_METRICS:
        reader = harness.load_module(
            ROOT / "rlbench" / "metrics" / f"{name}.py",
            "rlbench_metric_" + name.replace(".", "_"))
        metrics[name] = reader.read(rec)
    leads = [1e6 * x for x in program.kernel_leads(p)]
    slacks = [1e6 * x for x in program.wait_slacks(p)]
    out = {"metrics": metrics, "step_ms": program.step_split(p),
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

    import torch
    if not torch.cuda.is_available():
        print("trace_program: needs a CUDA card", file=sys.stderr)
        return 2
    config = harness.load_config(f"rlbench/configs/{cell['config']}.json")
    mix = harness.load_json(f"rlbench/traffic/{cell['traffic']}.json")
    limits = harness.load_json(f"rlbench/limits/{cell['name']}.json")
    driver = harness.load_module(
        ROOT / "rlbench" / "drivers" / f"{mix['driver']}.py",
        f"rlbench_driver_{mix['driver']}")
    ctx = {"config": config, "traffic": mix, "seed": args.seed,
           "seconds": args.seconds, "trace": bool(args.trace),
           "device": "cuda", "control": False,
           "clock": harness.Clock(T_START)}
    rec = run_recorded(driver, ctx, bool(args.recorder))
    torch.cuda.synchronize()
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_for(bj, cell["name"], kind):
        if m["name"] == "setup_s":
            metrics["setup_s"] = rec["setup_s"]
            continue
        reader = harness.load_module(
            ROOT / "rlbench" / "metrics" / f"{m['name']}.py",
            "rlbench_metric_" + m["name"].replace(".", "_"))
        metrics[m["name"]] = reader.read(rec)
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
