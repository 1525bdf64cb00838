"""The port's dry-run on a fake process group, in subprocesses (the group
is process-global):

- `python -m repro_torch.launch.dryrun --arch granite-3-2b --shape
  decode_32k --weight-update --wu-chunks 3` exits 0 with mesh 16x8 and
  the laws of the JAX package's `tests/test_dryrun.py` (its own test is
  red on this tree and is not the oracle): compute time > 0, 2-3 chunks
  whose collective times sum to the whole within 5%, and a largest chunk
  strictly between 0 and the whole;
- the weight update's collective bytes equal the analytic count from
  `logical_to_spec` under the trainer and generator rules, exactly;
- at one device the traced FLOPs of a smoke forward equal the hand count
  of its products (2*m*n*k each);
- a product with no replicated work: per-device count x devices equals
  the global count;
- `calibrated_roofline` equals the direct trace;
- `run_disaggregated("granite-3-2b")` is ok.
"""
import functools
import json
import os
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def test_dryrun_cli_single_combo(tmp_path):
    out = os.path.join(tmp_path, "dr.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "granite-3-2b", "--shape", "decode_32k",
         "--weight-update", "--wu-chunks", "3", "--out", out],
        env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rec = json.load(open(out))[0]
    assert rec["ok"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["mesh"] == "16x8"
    assert rec["t_compute_s"] > 0
    mem = rec["memory_analysis"]
    assert mem["peak_gb"] == pytest.approx(mem["argument_gb"]
                                           + mem["temp_gb"])
    ch = rec["weight_update_chunks"]
    assert 2 <= ch["n_chunks"] <= 3 and len(ch["chunks"]) == ch["n_chunks"]
    whole = rec["weight_update"]["t_collective_s"]
    assert ch["sum_t_collective_s"] == pytest.approx(whole, rel=0.05)
    assert 0 < ch["max_chunk_t_collective_s"] < whole


@functools.lru_cache(maxsize=None)
def _worker():
    out = os.path.join(tempfile.mkdtemp(prefix="dryrun_"), "w.json")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_dryrun_worker.py"),
         out], env=ENV, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.load(open(out))


def test_weight_update_bytes_equal_the_analytic_count():
    wu = _worker()["weight_update"]
    assert wu["traced"] == wu["analytic"]
    assert set(wu["kinds"]) == {"all-gather"}


def test_one_device_forward_flops_equal_the_hand_count():
    f = _worker()["smoke_forward"]
    assert f["traced"] == f["hand"]


def test_per_device_count_times_devices_is_global():
    p = _worker()["product"]
    assert p["per_device"] * p["devices"] == p["global"]
    assert p["coll"] == 0


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_calibrated_roofline_equals_the_direct_trace(arch):
    c = _worker()["calibrated"][arch]
    assert c["calibrated"] == pytest.approx(c["direct"], rel=1e-12)


def test_run_disaggregated_is_ok():
    d = _worker()["disaggregated"]
    assert d["ok"], d["error"]
    assert d["train_mesh"] == d["gen_mesh"] == "(16, 4)"
    assert d["terms"]["train"] > 0 and d["terms"]["serve"] > 0
