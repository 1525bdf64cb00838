"""The architecture modules (`rlbench/arch/`): the lookup by `model_type`,
an architecture the harness has not seen taken from files alone (a renamed
copy of `granite` in a temporary directory, through the weights, the
reference, the port's key map and a tiny rehearsal), the port's config
held to the file by the general guard, and the weights, counts and
reference of today's configurations as they were before the modules took
them."""
import dataclasses
import hashlib
import json
from pathlib import Path

import pytest
import torch

from rlbench import arch, flops, harness, port, rehearse, weights
from rlbench.drivers import rollout

ROOT = Path(__file__).resolve().parent.parent

# (dotted path, shape, dtype, scale) of every leaf in draw order, the
# counts (all, active, active less the embedding), and at the tiny size
# from seed 0 on the CPU: each leaf's (sum, sum of squares) and the
# reference's logits (sum, sum of |x|) and aux loss on fixed tokens, as
# `rlbench/weights.py`, `flops.py` and `reference/model.py` gave them
# before the architecture modules took them over
_S, _O = 0.0022360679774997894, 0.002886751345948129
BEFORE = {
    "granite-3-2b": {
        "specs": [
            ("embed", (49155, 2048), "bfloat16", 0.02),
            ("final_norm", (2048,), "bfloat16", -1.0),
            ("groups.0.norm1", (40, 2048), "bfloat16", -1.0),
            ("groups.0.attn.wq", (40, 2048, 32, 64), "bfloat16", 0.02),
            ("groups.0.attn.wk", (40, 2048, 8, 64), "bfloat16", 0.02),
            ("groups.0.attn.wv", (40, 2048, 8, 64), "bfloat16", 0.02),
            ("groups.0.attn.wo", (40, 32, 64, 2048), "bfloat16", _S),
            ("groups.0.norm2", (40, 2048), "bfloat16", -1.0),
            ("groups.0.ffn.gate", (40, 2048, 8192), "bfloat16", 0.02),
            ("groups.0.ffn.up", (40, 2048, 8192), "bfloat16", 0.02),
            ("groups.0.ffn.down", (40, 8192, 2048), "bfloat16", _S),
            ("lm_head", (2048, 49155), "bfloat16", 0.02),
            ("value_head", (2048, 1), "float32", 0.0)],
        "counts": (2634199040, 2634199040, 2533529600),
        "sums": [
            (-1.9183976691442695, 2.467115503410322), (64.0, 64.0),
            (128.0, 128.0), (-1.0993614480084943, 3.3438259775873673),
            (-0.9219706175472311, 1.6381573190940195),
            (-1.4555855935827822, 1.5940740450557505),
            (-1.7809760713494143, 0.8159965345871314), (128.0, 128.0),
            (0.034931911184514775, 6.545737414820874),
            (4.183740693303321, 6.478910381349406),
            (0.48561497800221787, 1.6521317153796067),
            (-0.9441387882384333, 2.4666756935077476), (0.0, 0.0)],
        "logits": (5.826948028948664, 366.9857161714722, 0.0)},
    "granite-moe-1b-a400m": {
        "specs": [
            ("embed", (49155, 1024), "bfloat16", 0.02),
            ("final_norm", (1024,), "bfloat16", -1.0),
            ("groups.0.norm1", (24, 1024), "bfloat16", -1.0),
            ("groups.0.attn.wq", (24, 1024, 16, 64), "bfloat16", 0.02),
            ("groups.0.attn.wk", (24, 1024, 8, 64), "bfloat16", 0.02),
            ("groups.0.attn.wv", (24, 1024, 8, 64), "bfloat16", 0.02),
            ("groups.0.attn.wo", (24, 16, 64, 1024), "bfloat16", _O),
            ("groups.0.norm2", (24, 1024), "bfloat16", -1.0),
            ("groups.0.moe.router", (24, 1024, 32), "float32", 0.02),
            ("groups.0.moe.gate", (24, 32, 1024, 512), "bfloat16", 0.02),
            ("groups.0.moe.up", (24, 32, 1024, 512), "bfloat16", 0.02),
            ("groups.0.moe.down", (24, 32, 512, 1024), "bfloat16", _O),
            ("lm_head", (1024, 49155), "bfloat16", 0.02),
            ("value_head", (1024, 1), "float32", 0.0)],
        "counts": (1384962048, 478992384, 428657664),
        "sums": [
            (-1.9183976691442695, 2.467115503410322), (64.0, 64.0),
            (128.0, 128.0), (-1.0993614480084943, 3.3438259775873673),
            (-0.9219706175472311, 1.6381573190940195),
            (-1.4555855935827822, 1.5940740450557505),
            (-1.7809760713494143, 0.8159965345871314), (128.0, 128.0),
            (0.4230326505621633, 0.4064596354144111),
            (4.434555827218389, 13.02070247937375),
            (-1.1989179452041299, 13.295694250969989),
            (-2.123644185824446, 3.274901296870575),
            (-2.2714941035237644, 2.428116818889534), (0.0, 0.0)],
        "logits": (0.3185013126967533, 369.38715703346315,
                   2.0153024196624756)},
}


def config(name):
    return harness.load_config(f"rlbench/configs/{name}.json")


def reference_logits(c, seed=0):
    """The reference's logits on fixed tokens at the tiny size of `c`."""
    t = rehearse.tiny_config(c)
    p = weights.make_params(t, seed, "cpu", dtype=torch.float32)
    tok = torch.arange(3 * 10).reshape(3, 10) % t["vocab_size"]
    hn, aux = arch.model(t, p).hidden(tok)
    return (hn @ p["lm_head"]).double(), float(aux)


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_layout_counts_and_reference_as_before(name):
    c, want = config(name), BEFORE[name]
    got = [(".".join(path), tuple(shape), dt, scale)
           for path, shape, dt, scale in weights.leaf_specs(c)]
    assert got == want["specs"]
    assert (flops.param_count(c), flops.param_count(c, active_only=True),
            flops.active_params_no_embed(c)) == want["counts"]
    t = rehearse.tiny_config(c)
    drawn = weights.leaves(weights.make_params(t, 0, "cpu"), t)
    assert [n for n, _ in drawn] == [s[0] for s in want["specs"]]
    # a different draw order, shape or scale moves a sum by O(1) and a sum
    # of squares by far more than 0.1%; a bf16 rounding that another CPU
    # takes the other way moves them by ~1e-4
    for (n, x), (s, s2) in zip(drawn, want["sums"]):
        x = x.double()
        assert float(x.sum()) == pytest.approx(s, abs=2e-3), n
        assert float(x.square().sum()) == pytest.approx(s2, rel=1e-3), n
    logits, aux = reference_logits(c)
    s, a, aux_want = want["logits"]
    assert float(logits.sum()) == pytest.approx(s, abs=1e-3)
    assert float(logits.abs().sum()) == pytest.approx(a, rel=1e-5)
    assert aux == pytest.approx(aux_want, rel=1e-5, abs=1e-9)


def test_lookup_by_model_type_and_directory(tmp_path):
    assert arch.of(config("granite-3-2b")).__name__ == "rlbench.arch.granite"
    moe = arch.of(config("granite-moe-1b-a400m"))
    assert moe is arch.load("granitemoe")
    with pytest.raises(KeyError, match="granite_twin"):
        arch.load("granite_twin")
    twin = write_twin(tmp_path)[0]
    assert arch.load("granite_twin", twin) is arch.load("granite_twin", twin)


def write_twin(tmp_path):
    """A renamed copy of the granite module (`model_type` granite_twin) and
    a configuration file of it, written into `tmp_path`: an architecture
    and a configuration the harness has not seen. Returns the directory
    and the configuration as run."""
    src = (ROOT / "rlbench/arch/granite.py").read_text()
    (tmp_path / "granite_twin.py").write_text(src)
    raw = json.loads((ROOT / "rlbench/configs/granite-3-2b.json").read_text())
    raw.update(name="granite-twin", model_type="granite_twin")
    (tmp_path / "granite-twin.json").write_text(json.dumps(raw))
    c = json.loads((tmp_path / "granite-twin.json").read_text())
    return tmp_path, {**c, **c["as_run"]}


def tree_digest():
    h = hashlib.sha256()
    for p in sorted((ROOT / "rlbench").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(ROOT)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_new_architecture_is_files_only(tmp_path, monkeypatch):
    """A `model_type` the harness has not seen goes from its two files to
    a correct tiny rehearsal with no edit to the harness: weights, the
    reference, the port's key map and the rollout cell's driver, check and
    limits."""
    from repro_torch.models import model as M
    before = tree_digest()
    g = rehearse.tiny_config(config("granite-3-2b"))
    want = weights.leaves(weights.make_params(g, 5, "cpu"), g)
    want_logits = reference_logits(config("granite-3-2b"), 5)[0]
    directory, c = write_twin(tmp_path)
    monkeypatch.setattr(arch, "DIR", directory)
    assert arch.of(c).__file__ == str(directory / "granite_twin.py")
    t = rehearse.tiny_config(c)
    got = weights.leaves(weights.make_params(t, 5, "cpu"), t)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), n
    assert flops.param_count(c) == BEFORE["granite-3-2b"]["counts"][0]
    torch.testing.assert_close(reference_logits(c, 5)[0], want_logits,
                               rtol=0, atol=0)
    with rehearse.tiny_port(t):
        cfg = port.config(t, "cpu")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff) == (2, 64, 128)
    p = weights.make_params(t, 3, "cpu")
    tok = torch.arange(2 * 12).reshape(2, 12) % t["vocab_size"]
    pos = torch.arange(12)[None].expand(2, 12)
    out = M.forward(p, tok, pos, dataclasses.replace(cfg, fused_loss=False))
    hn, _ = arch.model(t, p).hidden(tok)
    torch.testing.assert_close(hn @ p["lm_head"], out["logits"], rtol=1e-4,
                               atol=1e-5)

    torch.set_num_threads(2)
    mix = rehearse.tiny_rollout_traffic(
        harness.load_json("rlbench/traffic/rollout-grpo512.json"))
    ctx = {"config": t, "traffic": mix, "seed": 2 ** 31 + 11,
           "seconds": 0.5, "trace": False, "device": "cpu",
           "control": False, "clock": harness.Clock()}
    with rehearse.tiny_port(t):
        rec = rollout.run(ctx)
    limits = harness.load_json("rlbench/limits/granite-2b.rollout.json")
    for k, lim in limits.items():
        assert rec["checks"][k] <= lim, (k, rec["checks"])
    assert rec["attempted"] > 0
    assert tree_digest() == before


def test_port_config_refuses_what_the_file_does_not_state(monkeypatch):
    """The guard in general form: a field the architecture does not map
    from a file key, off its default, and a mapped size that differs from
    the file, are each refused; a null in the file is the field's
    default."""
    import repro_torch
    c = rehearse.tiny_config(config("granite-moe-1b-a400m"))
    with rehearse.tiny_port(c):
        port.config(c, "cpu")
    for extra in ({"n_shared_experts": 2}, {"n_dense_layers": 1},
                  {"use_qk_norm": True}, {"use_value_head": False},
                  {"arch_type": "dense"}, {"experts_per_token": 4}):
        make = (lambda raw, e=extra: lambda name: dataclasses.replace(
            raw(name), **e))
        with rehearse.tiny_port(c), \
                rehearse.patched(repro_torch, "get_config", make):
            with pytest.raises(SystemExit, match="differs from the file"):
                port.config(c, "cpu")
    monkeypatch.setitem(arch.of(c).PORT_FIELDS, "q_lora_rank", "q_lora_rank")
    with rehearse.tiny_port(c):
        port.config(dict(c, q_lora_rank=None), "cpu")
        with pytest.raises(SystemExit, match="q_lora_rank"):
            port.config(dict(c, q_lora_rank=64), "cpu")


def test_layer_groups_past_the_first(tmp_path, monkeypatch):
    """A layout with two groups of layers (leading dense layers, then
    experts, as the port lays them out) is drawn, listed and rebuilt leaf
    for leaf."""
    (tmp_path / "two_groups.py").write_text(
        "def leaf_specs(c):\n"
        "    f = 'float32'\n"
        "    return [(('embed',), (5, 3), f, 0.02),\n"
        "            (('groups', '0', 'ffn', 'up'), (1, 3, 4), f, 0.02),\n"
        "            (('groups', '1', 'moe', 'up'), (2, 3, 4), f, 0.02),\n"
        "            (('groups', '1', 'norm2'), (2, 3), f, -1.0)]\n")
    monkeypatch.setattr(arch, "DIR", tmp_path)
    c = {"model_type": "two_groups"}
    tree = weights.make_params(c, 1, "cpu")
    assert [sorted(g) for g in tree["groups"]] == [["ffn"], ["moe", "norm2"]]
    names = [n for n, _ in weights.leaves(tree, c)]
    assert names == ["embed", "groups.0.ffn.up", "groups.1.moe.up",
                     "groups.1.norm2"]
    again = weights.tree_of(c, [x for _, x in weights.leaves(tree, c)])
    assert again["groups"][1]["moe"]["up"] is tree["groups"][1]["moe"]["up"]
