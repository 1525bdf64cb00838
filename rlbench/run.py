"""Run one cell of the benchmark once:

    python3 rlbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (`rlbench/configs/<config>.json`) and traffic mix
(`rlbench/traffic/<mix>.json`); the mix names its driver
(`rlbench/drivers/<driver>.py`), each per-layer metric has its reader
(`rlbench/metrics/<metric>.py`) and each cell its limits
(`rlbench/limits/<cell>.json`). Prints the checks' numbers beside their
limits as the last lines of standard error and one JSON result as the
last line of standard output. With `--trace 0` the metrics are the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, read from the
benchmark's own host spans, the profiler's trace of the window's first
batches and the program's own spans and counters (`rlbench/program.py`).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_env() -> None:
    """Caches inside the checkout, at fixed paths; the port's kernels build
    into its own fixed `build/repro_torch/`."""
    cache = ROOT / "build" / "rlbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def cell_of(bench: dict, name: str) -> dict:
    """The cell `name` of BENCHMARK.json, or of the cells that wait
    (`rlbench/waiting.json`, which report no metrics)."""
    waiting = json.loads((ROOT / "rlbench" / "waiting.json").read_text())
    for w in bench["workloads"] + waiting["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell
    reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def loaded_forbidden() -> list:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every limited number present,
    finite and within its limit."""
    shown, ok = {}, True
    for name, lim in limits.items():
        v = checks.get(name)
        number = isinstance(v, (int, float)) and math.isfinite(v)
        ok = ok and number and v <= lim
        # JSON has no infinity: a missing or infinite reading shows as null
        shown[name] = {"value": v if number else None, "limit": lim}
    return ok, shown


def breakdown(traced: dict) -> dict:
    ops = sorted(traced["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(traced["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def needs_cards(cell: dict) -> bool:
    """False, with the reason on standard error, where this machine lacks
    the CUDA cards the cell asks for."""
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"rlbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return False
    return True


def context(cell: dict, seed: int, seconds: float, trace: bool,
            control: bool = False, t_start: float = T_START) -> tuple:
    """(the driver's context, its module, the cell's limits), from the
    files that the cell names."""
    from rlbench import harness
    mix = harness.load_json(f"rlbench/traffic/{cell['traffic']}.json")
    ctx = {"config": harness.load_config(
               f"rlbench/configs/{cell['config']}.json"),
           "traffic": mix, "seed": seed, "seconds": seconds, "trace": trace,
           "device": "cuda", "control": control,
           "clock": harness.Clock(t_start)}
    driver = harness.load_module(
        ROOT / "rlbench" / "drivers" / f"{mix['driver']}.py",
        f"rlbench_driver_{mix['driver']}")
    return ctx, driver, harness.load_json(f"rlbench/limits/{cell['name']}.json")


def read_metrics(bench: dict, cell: dict, rec: dict, kind: str) -> dict:
    """{name: value} of the cell's metrics of `kind`, each read by its
    reader (`rlbench/metrics/<name>.py`); None where it found nothing."""
    from rlbench import harness
    out = {}
    for m in metrics_for(bench, cell["name"], kind):
        if m["name"] == "setup_s":
            out["setup_s"] = rec["setup_s"]
            continue
        reader = harness.load_module(
            ROOT / "rlbench" / "metrics" / f"{m['name']}.py",
            "rlbench_metric_" + m["name"].replace(".", "_"))
        out[m["name"]] = reader.read(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the float8 reference in the program's place "
                         "(the control of the check; not a benchmark run)")
    ap.add_argument("--fault", choices=("altered_token", "unchanged_step",
                                        "half_batch"),
                    help="plant a fault under the timed path (a reading of "
                         "the check's faults; not a benchmark run)")
    args = ap.parse_args(argv)
    _setup_env()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(bench, args.workload)
    if not needs_cards(cell):
        return 2

    import torch
    from rlbench import flops, program
    ctx, driver, limits = context(cell, args.seed, args.seconds,
                                  bool(args.trace), args.control)
    planted = contextlib.nullcontext()
    if args.fault:
        from rlbench import rehearse
        planted = getattr(rehearse, args.fault)()
    # a traced run records the program's own spans and counters too
    with planted:
        rec = program.run_driver(driver, ctx, bool(args.trace))
    torch.cuda.synchronize()
    print(json.dumps({"setup_s": rec["setup_s"],
                      "setup_parts": rec["setup_parts"],
                      "window": rec["window"], "checks": rec["checks"],
                      "power_limit": flops.card_power_limit()},
                     default=str), flush=True)

    kind = "per_layer" if args.trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in bench[kind]}
    metrics = {name: {"value": v, "unit": units[name]} for name, v in
               read_metrics(bench, cell, rec, kind).items() if v is not None}

    bad = loaded_forbidden()
    if bad:
        print(f"rlbench: modules loaded that the benchmark forbids: {bad}",
              file=sys.stderr)
        return 3
    correct, shown = judge(rec["checks"], limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": bool(correct), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if args.trace and rec.get("traced"):
        device["busy_s"] = rec["traced"]["busy_s"]
        device["window_s"] = rec["traced"]["window_s"]
        out["breakdown"] = breakdown(rec["traced"])
    out["checks"] = shown
    for name, s in shown.items():
        print(f"check {name}: {s['value']} (limit {s['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
