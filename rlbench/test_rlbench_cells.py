"""Each cell's driver, reference and judgement at a tiny size on the CPU,
the cells that wait (`waiting.json`) among them: a sound run comes out
correct; with the timed path broken underneath (a token altered where it
is produced, an optimizer step that returns its state unchanged, half of
the batch left out of the loss) it comes out not correct. A cell with
four chips would add the exchange left out; these run on one. The card
test runs every cell of BENCHMARK.json for a short window."""
import importlib.util
import json
from contextlib import nullcontext
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rlbench import harness, rehearse
from rlbench.drivers import loop, rollout, train

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WAITING = json.loads((ROOT / "rlbench/waiting.json").read_text())
WORKLOADS = BENCH["workloads"] + WAITING["workloads"]
DRIVERS = {"loop": loop, "rollout": rollout, "train": train}


def _judge():
    spec = importlib.util.spec_from_file_location("rlbench_run_j",
                                                  ROOT / "rlbench/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    return run.judge


def rehearse_cell(cell, fault=None, control=False):
    torch.set_num_threads(2)
    w = next(w for w in WORKLOADS if w["name"] == cell)
    c = rehearse.tiny_config(
        harness.load_config(f"rlbench/configs/{w['config']}.json"))
    mix = harness.load_json(f"rlbench/traffic/{w['traffic']}.json")
    t = rehearse.TINY_TRAFFIC[mix["driver"]](mix)
    ctx = {"config": c, "traffic": t, "seed": 2 ** 31 + 3, "seconds": 0.5,
           "trace": False, "device": "cpu", "control": control,
           "clock": harness.Clock()}
    with rehearse.tiny_port(c), (fault() if fault else nullcontext()):
        rec = DRIVERS[mix["driver"]].run(ctx)
    limits = harness.load_json(f"rlbench/limits/{cell}.json")
    return _judge()(rec["checks"], limits), rec


CELLS = {w["name"]: json.loads((ROOT / f"rlbench/traffic/{w['traffic']}.json")
                               .read_text())["driver"]
         for w in WORKLOADS}
FAULTS = {"rollout": {"altered_token": rehearse.altered_token},
          "loop": {"altered_token": rehearse.altered_token,
                   "unchanged_step": rehearse.unchanged_step,
                   "half_batch": rehearse.half_batch},
          "train": {"unchanged_step": rehearse.unchanged_step,
                    "half_batch": rehearse.half_batch}}
CASES = [(cell, f) for cell, d in CELLS.items() for f in [None, *FAULTS[d]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_rehearsed_cell(cell, fault):
    make = FAULTS[CELLS[cell]][fault] if fault else None
    (correct, shown), rec = rehearse_cell(cell, make)
    assert correct == (fault is None), shown
    assert rec["window"]["seconds"] >= 0.5 and rec["attempted"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_stands_apart(cell):
    """The float8 reference in the program's place reads far above a sound
    run on at least one compared number (on the card, at the cell's size,
    it fails the limits: PERF.md)."""
    sound = rehearse_cell(cell)[1]["checks"]
    ctl = rehearse_cell(cell, control=True)[1]["checks"]
    limits = harness.load_json(f"rlbench/limits/{cell}.json")
    assert any(ctl[k] > 100 * max(sound[k], 1e-9) for k in limits
               if isinstance(ctl.get(k), float)), (sound, ctl)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(w["name"]
                                         for w in BENCH["workloads"]))
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "rlbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "10", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
