"""BENCHMARK.json against the rules it is held to, and the benchmark's
files against BENCHMARK.json: names and units, one reader and one limits
file for each thing that needs one, `moves` within the same cells, and a
reference that imports nothing of the program."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_budget():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24  # the most cells a later benchmark may hold
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and ".." not in p


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_metric_entries():
    e2e = BENCH["end_to_end"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def reports(cell, kind):
    import importlib.util
    spec = importlib.util.spec_from_file_location("rlbench_run",
                                                  ROOT / "rlbench/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    return {m["name"] for m in run.metrics_for(BENCH, cell, kind)}


def test_waiting_cells_have_their_files():
    waiting = json.loads((ROOT / "rlbench/waiting.json").read_text())
    names = {w["name"] for w in BENCH["workloads"]}
    for w in waiting["workloads"]:
        assert w["name"] not in names and NAME.match(w["name"])
        assert (ROOT / f"rlbench/configs/{w['config']}.json").is_file()
        assert (ROOT / f"rlbench/limits/{w['name']}.json").is_file()
        assert (ROOT / f"rlbench/traffic/{w['traffic']}.json").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_it_needs(cell):
    e2e = reports(cell, "end_to_end")
    layer = reports(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in BENCH["per_layer"]:
        if m["name"] in layer:
            # the metric it moves is one this cell reports
            assert m["moves"] in e2e, (m["name"], cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (ROOT / f"rlbench/limits/{cell}.json").is_file()
    assert (ROOT / f"rlbench/traffic/{w['traffic']}.json").is_file()
    mix = json.loads((ROOT / f"rlbench/traffic/{w['traffic']}.json")
                     .read_text())
    assert (ROOT / f"rlbench/drivers/{mix['driver']}.py").is_file()


def test_every_config_used_and_every_metric_read():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        # run.py finds a cell's configuration by its name
        assert c["file"] == f"rlbench/configs/{c['name']}.json"
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] != "setup_s":
            assert (ROOT / f"rlbench/metrics/{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    p.name for p in (ROOT / "rlbench/reference").glob("*.py")) + sorted(
    "../arch/" + p.name for p in (ROOT / "rlbench/arch").glob("*.py")) + [
    "../weights.py", "../flops.py", "../traffic.py"])
def test_reference_imports_nothing_of_the_program(path):
    got = top_level_imports(ROOT / "rlbench/reference" / path)
    assert not got & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                      "benchmarks"}, got


def test_nothing_in_the_harness_imports_jax():
    for p in (ROOT / "rlbench").rglob("*.py"):
        got = top_level_imports(p)
        assert not got & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, p


def test_judge_needs_every_number_within_its_limit():
    import importlib.util
    spec = importlib.util.spec_from_file_location("rlbench_run_judge",
                                                  ROOT / "rlbench/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    limits = {"a": 0.5, "b": 0}
    assert run.judge({"a": 0.1, "b": 0}, limits)[0]
    for bad in ({"a": 0.6, "b": 0}, {"a": 0.1, "b": 1}, {"a": 0.1},
                {"a": float("inf"), "b": 0}, {"a": None, "b": 0}):
        ok, shown = run.judge(bad, limits)
        assert not ok
        json.loads(json.dumps(shown, allow_nan=False))
