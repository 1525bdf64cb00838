"""Each metric reader on a canned record: what it reads, and None where
the record has nothing to read."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from rlbench import flops, harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CFG = harness.load_config("rlbench/configs/granite-3-2b.json")
LOOP = json.loads((ROOT / "rlbench/traffic/loop-grpo512.json").read_text())
ROLLOUT = json.loads((ROOT / "rlbench/traffic/rollout-grpo512.json")
                     .read_text())
TRAIN = json.loads((ROOT / "rlbench/traffic/train-pack4096.json").read_text())


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), ROOT / f"rlbench/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(traffic, traced=True):
    table = np.array([[1, 2, 0, 0, 0, 0, 0, 0], [1, 3, 0, 0, 0, 0, 0, 0]])
    spans = [("decode", 1.0, 1.1, {}), ("decode", 1.2, 1.4, {}),
             ("refill", 1.4, 1.5, {"admitted": 2}),
             ("refill", 1.5, 1.52, {"admitted": 0}),
             ("swap", 1.6, 1.61, {"version": 3, "done": False}),
             ("swap", 1.7, 1.72, {"version": 3, "done": True}),
             ("pre", 2.0, 2.5, {"tokens": 8192}),
             ("trainer", 3.0, 5.0, {})]
    return {"cfg": CFG, "traffic": traffic, "t_open": 1.0, "t_close": 11.0,
            "t_prof_end": 6.0, "spans": spans,
            "decode": [(1.0, 1.1, np.array([70, 100]), table)],
            "window": {"seconds": 10.0, "sampled_tokens": 5000,
                       "prefill_tokens": 1000, "pre_tokens": 8192,
                       "trained_tokens": 8192},
            "traced": ({"busy_s": 2.0, "window_s": 5.0,
                        "by_name": {"void repro::dec::split_kernel<repro::"
                                    "PagedAddr>": 0.01,
                                    "void repro::flp_tc::fwd_kernel": 0.05,
                                    "void repro::flp_tc::dw_kernel": 0.05,
                                    "ampere_sgemm": 1.0}}
                       if traced else None)}


def test_end_to_end_rates():
    rec = record(LOOP)
    assert reader("loop_tokens_per_s")(rec) == 500.0
    assert reader("rollout_tokens_per_s")(rec) == 500.0
    assert reader("train_tokens_per_s")(rec) == 819.2


def test_host_span_readers():
    rec = record(LOOP)
    assert reader("engine.decode_ms")(rec) == pytest.approx(150.0)
    assert reader("engine.refill_ms")(rec) == pytest.approx(100.0)
    assert reader("swap.install_ms")(rec) == pytest.approx(30.0)
    assert reader("pre.ms_per_ktok.loop")(rec) == pytest.approx(500 / 8.192)
    assert reader("pre.ms_per_ktok.rollout")(rec) \
        == pytest.approx(500 / 8.192)
    assert reader("trainer.ms_per_ktok.train")(rec) \
        == pytest.approx(2000 / 8.192)
    inside = 0.1 + 0.2 + 0.1 + 0.02 + 0.01 + 0.02 + 0.5 + 2.0
    assert reader("loop.self_share")(rec) == pytest.approx(
        100 * (10 - inside) / 10)


def test_device_readers():
    rec = record(LOOP)
    assert reader("device.idle.loop")(rec) == pytest.approx(60.0)
    n = flops.active_params_no_embed(CFG)
    want = 100 * (6 * n * 8192 + 2 * n * (5000 + 1000 + 8192)) / (10 * 989e12)
    assert reader("mfu.loop")(rec) == pytest.approx(want)
    assert reader("device.idle.rollout")(rec) == pytest.approx(60.0)
    want = 100 * 2 * n * (5000 + 1000 + 8192) / (10 * 989e12)
    assert reader("mfu.rollout")(rec) == pytest.approx(want)


def test_paged_decode_roofline():
    rec = record(ROLLOUT)
    # rows of 70 and 100 keys share page 1: 64 + 6 + 36 valid keys
    assert flops.paged_valid_keys(rec["decode"][0][3], [70, 100], 64) == 106
    one = flops.paged_decode_launch(256, 32, 8, 64, 8, 106, 170)
    want = 40 * flops.bound_seconds(one["bytes"], one["flops"]) / 0.01
    assert reader("paged_decode_roofline")(rec) == pytest.approx(100 * want)


def test_fused_loss_roofline():
    rec = record(TRAIN)
    n = 4 * 4096
    want = sum(flops.bound_seconds(f["bytes"], f["flops"]) for f in (
        flops.fused_loss_fwd(8192, 2048, 49155),
        flops.fused_loss_fwd(n, 2048, 49155),
        flops.fused_loss_bwd(n, 2048, 49155)))
    assert reader("fused_loss_roofline")(rec) == pytest.approx(
        100 * want / 0.1)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_nothing_to_read_gives_none(name):
    rec = record(LOOP, traced=False)
    rec["spans"], rec["decode"] = [], []
    if name.startswith("mfu"):
        rec["window"]["seconds"] = 0.0
    assert reader(name)(rec) is None
