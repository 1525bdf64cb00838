"""The granite-4h-micro cell's own pieces (granite-4.0-h-micro, Mamba2 and
NoPE attention layers interleaved): the architecture file's pattern and
count against the port's config, the three readers it adds on canned
records, a traced CPU rehearsal of the cell with the program's recorder
on, and the rule that keeps `paged_decode_roofline` to cells whose every
layer has attention."""
import json
import math
from pathlib import Path

import pytest
import torch

from rlbench import harness, program, rehearse, weights
from rlbench.arch import granitemoehybrid as ARCH
from rlbench.drivers import rollout
from rlbench.test_rlbench_metrics import ROLLOUT, record, reader
from rlbench.test_rlbench_program import canned

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CFG = harness.load_config("rlbench/configs/granite-4.0-h-micro.json")


def test_pattern_and_count_are_the_ports():
    """The file's `layer_pattern` (what the port's config is held to) spells
    its published `layer_types`, at full size and at the tiny one, and the
    architecture's count is the port's."""
    from repro_torch import get_config
    for c in (CFG, rehearse.tiny_config(CFG)):
        ARCH.check_pattern(c)
    with pytest.raises(ValueError, match="layer_pattern"):
        ARCH.check_pattern(dict(CFG, layer_pattern="A" * 40))
    cfg = get_config(CFG["port_arch"])
    assert cfg.layer_pattern == CFG["layer_pattern"]
    assert cfg.param_count() == ARCH.param_count(CFG) == 3396608512


def test_paged_decode_roofline_lists_cells_with_attention_in_every_layer():
    """`paged_decode_roofline` counts one launch of the paged kernel per
    layer (`num_hidden_layers`): a cell whose configuration has layers
    without attention would read it too high."""
    m = next(m for m in BENCH["per_layer"]
             if m["name"] == "paged_decode_roofline")
    configs = {w["name"]: w["config"] for w in BENCH["workloads"]}
    for cell in m["workloads"]:
        c = json.loads((ROOT / f"rlbench/configs/{configs[cell]}.json")
                       .read_text())
        types = c.get("layer_types", ["attention"] * c["num_hidden_layers"])
        assert types.count("attention") == c["num_hidden_layers"], cell


def test_ssd_scan_roofline():
    """36 launches a Preprocessor call of 16 rows of 512 tokens, each bound
    by its bytes: x and y (bf16, 64 heads of 64), B and C (bf16, 128), dt
    (float32 a head), A, and the float32 final state."""
    rec = record(ROLLOUT)
    rec["cfg"] = CFG
    rec["traced"]["by_name"]["void repro::ssd::mma_kernel<64>"] = 0.02
    tok = 16 * 512
    nbytes = (tok * (2 * 64 * 64 + 2 * 128) * 2 + tok * 64 * 4 + 64 * 4
              + 16 * 64 * 64 * 128 * 4)
    want = 36 * nbytes / 3.35e12 / 0.02
    assert reader("ssd_scan_roofline")(rec) == pytest.approx(100 * want)


def test_decode_step_roofline():
    """One traced step of two rows: every weight but the embedding's unread
    rows, the 106 valid keys and values of the 4 attention layers read and
    the 2 new ones written, and each row's conv and SSD state of the 36
    Mamba2 layers read and written, over the card's 0.03 s busy inside the
    step."""
    rec = record(ROLLOUT)
    rec["cfg"] = CFG
    rec["program"] = {"busy": [(0.99, 1.02), (1.05, 1.06), (1.2, 1.3)]}
    leaves = sum(math.prod(shape) * (4 if dt == "float32" else 2)
                 for path, shape, dt, _ in weights.leaf_specs(CFG))
    weights_b = leaves - 100352 * 2048 * 2 + 2 * 2048 * 2
    kv = 4 * 2 * (106 + 2) * 8 * 64 * 2
    state = 36 * 2 * 2 * (3 * (4096 + 256) * 2 + 64 * 64 * 128 * 4)
    want = (weights_b + kv + state) / 3.35e12 / 0.03
    assert reader("decode_step_roofline")(rec) == pytest.approx(100 * want)


def test_ssm_host_share_reads_the_mamba2_spans_of_the_window_steps():
    rec = canned()
    spans = rec["program"]["spans"]
    # the first step's enqueue (index 2) holds two Mamba2 layers' spans of
    # 0.03 and 0.05 s; a third outside every step counts nowhere
    spans += [("model.decode.ssm", 0.11, 0.14, 2, {"layer": 0}),
              ("model.decode.ssm", 0.15, 0.2, 2, {"layer": 1}),
              ("model.decode.ssm", 0.72, 0.73, -1, {"layer": 0})]
    assert reader("engine.step.ssm_host_share")(rec) == pytest.approx(
        100 * 0.08 / ((0.7 - 0.3) + (0.2 - 0.1)))


def test_traced_rehearsal_runs_the_new_readers():
    """The cell at the tiny size, traced with the recorder: its Mamba2
    layers' decode spans and the forks' recurrent rows are recorded; on the
    CPU the SSM share reads a number and the two rooflines, which need the
    device trace, read nothing."""
    torch.set_num_threads(2)
    c = rehearse.tiny_config(CFG)
    t = rehearse.tiny_rollout_traffic(
        harness.load_json("rlbench/traffic/rollout-grpo512.json"))
    ctx = {"config": c, "traffic": t, "seed": 2 ** 31 + 5, "seconds": 0.5,
           "trace": True, "device": "cpu", "control": False,
           "clock": harness.Clock()}
    with rehearse.tiny_port(c):
        rec = program.run_driver(rollout, ctx, True)
    spans = rec["program"]["spans"]
    ssm = [s for s in spans if s[0] == "model.decode.ssm"]
    steps = [s for s in spans if s[0] == "engine.step"]
    # three of the five layers are Mamba2 layers: 0, 1 and 3
    assert steps and len(ssm) == 3 * len(steps)
    assert {s[4]["layer"] for s in ssm} == {0, 1, 3}
    assert all(spans[s[3]][0] == "engine.step.enqueue" for s in ssm)
    forks = [s[4]["state_rows"] for s in spans
             if s[0] == "engine.refill.fork"]
    assert forks and all(n > 0 for n in forks)
    assert 0 < reader("engine.step.ssm_host_share")(rec) < 100
    assert reader("ssd_scan_roofline")(rec) is None
    assert reader("decode_step_roofline")(rec) is None
    assert rec["checks"]["rollouts_unchecked"] == 0
