"""granite-4.0-h-micro's interleaved layers in the port (Mamba2 layers and
NoPE GQA layers in the published order, `ModelConfig.layer_pattern`), on
the CPU at the tiny sizes of the benchmark's architecture file
(`rlbench/arch/granitemoehybrid.py` `TINY`: five layers "MMAMA"), held
against that file's plain float32 reference, which runs the Mamba2
recurrence token by token and imports nothing of the port.

- The port's pattern spells the published `layer_types`; its caches stack
  the attention leaves over the attention layers and the conv and SSD
  state over the Mamba2 layers; its analytic count and weight layout are
  the architecture file's.
- NoPE: the attention layers' output does not move when every position
  is shifted (and does under RoPE).
- A paged engine with GRPO prefix forks, refills that admit fewer rows
  than the slots (the compact refill) and chunked prefill over several
  chunks: every decode step's logits equal the reference's full forward
  of the finished rollout at that position, and the paged engine equals
  the slot engine bit for bit.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from rlbench import harness, port, rehearse, weights
from rlbench.arch import granitemoehybrid as ARCH
from repro_torch import EngineConfig, GenerationEngine, get_config
from repro_torch.configs.base import kv_cache_specs, paged_cache_specs
from repro_torch.data.math_task import Problem
from repro_torch.models import attention as TA
from repro_torch.models import model as M
from torch_twin import one_thread

FILE = harness.load_config("rlbench/configs/granite-4.0-h-micro.json")
TINY = rehearse.tiny_config(FILE)
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def tiny():
    """The port's config at the tiny sizes (float32) and the benchmark's
    weights from seed 3."""
    with rehearse.tiny_port(TINY):
        cfg = port.config(TINY, "cpu")
    return cfg, weights.make_params(TINY, 3, "cpu")


def test_layer_pattern_is_the_published_layer_types():
    cfg = get_config("granite-4.0-h-micro")
    assert cfg.layer_pattern == ARCH.pattern(FILE) == FILE["layer_pattern"]
    assert [i for i, m in enumerate(cfg.layer_pattern) if m == "A"] \
        == [5, 15, 25, 35]
    assert TINY["layer_pattern"] == ARCH.pattern(TINY) == "MMAMA"
    assert (cfg.n_attention_layers, cfg.n_ssm_layers) == (4, 36)
    assert M.layer_groups(cfg) == [("dense", 36), ("dense", 4)]
    assert M.group_mixers(cfg) == "MA"
    slot = kv_cache_specs(cfg, 256, 512)
    paged = paged_cache_specs(cfg, 256, 512, 2049, 64)
    assert slot["k"][0] == (4, 256, 512, 8, 64)
    assert paged["v"][0] == (4, 2049, 64, 8, 64)
    for s in (slot, paged):
        assert s["conv"][0] == (36, 256, 3, 4096 + 2 * 128)
        assert s["ssd"] == ((36, 256, 64, 64, 128), torch.float32)
    with pytest.raises(ValueError, match="layer_pattern"):
        dataclasses.replace(cfg, layer_pattern="MA" * 19)
    with pytest.raises(ValueError, match="layer_pattern"):
        dataclasses.replace(get_config("granite-3-2b"),
                            layer_pattern="A" * 40)


@pytest.mark.parametrize("c", [FILE, TINY], ids=["full", "tiny"])
def test_count_and_layout_are_the_architecture_files(c):
    with rehearse.tiny_port(c) if c is TINY else contextlib.nullcontext():
        cfg = port.config(c, "cpu")
    assert cfg.param_count() == ARCH.param_count(c)
    want = {".".join(path): (tuple(shape), dt)
            for path, shape, dt, _ in ARCH.leaf_specs(c)}

    def flat(tree, path=""):
        if isinstance(tree, tuple):
            return {path[1:]: (tuple(tree[0]), str(tree[1])[6:])}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items
                for k, v in flat(sub, f"{path}.{key}").items()}

    assert flat(M.param_shapes(cfg)) == want


def test_nope_attention_ignores_positions(tiny):
    """Every position shifted, or spread three times as far apart: the
    attention layer's output is the same bit for bit. RoPE scores hold
    relative positions, so the spread (not the shift) moves them."""
    cfg, p = tiny
    lp = M.layer_views(p["groups"][1]["attn"], 2)[0]
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(12)[None].expand(2, 12)
    a = TA.gqa_forward(lp, x, pos, cfg)
    assert torch.equal(a, TA.gqa_forward(lp, x, pos + 7, cfg))
    assert torch.equal(a, TA.gqa_forward(lp, x, 3 * pos, cfg))
    rope = dataclasses.replace(cfg, position_embedding="rope")
    assert not torch.allclose(TA.gqa_forward(lp, x, pos, rope),
                              TA.gqa_forward(lp, x, 3 * pos, rope),
                              atol=1e-4)


def _groups(lengths, seed=0):
    """GRPO groups of 4 copies of prompts of `lengths` ids."""
    rng = np.random.default_rng(seed)
    ids = [rng.integers(3, TINY["vocab_size"], n).tolist() for n in lengths]
    return [p for p in ids for _ in range(4)]


def _engine(cfg, p, prompts, **ec):
    kw = dict(n_slots=10, max_len=32, prefill_chunk=8, temperature=1.0,
              eos_id=-1)
    kw.update(ec)
    it = iter([Problem(list(x), 0) for x in prompts])
    return GenerationEngine(cfg, p, EngineConfig(**kw), lambda: next(it, None),
                            seed=11, **CPU)


def _drain(eng, steps=200):
    out = []
    for _ in range(steps):
        eng.refill()
        out += eng.step()
        if eng.n_active == 0:
            break
    return out


PROMPTS = _groups([13, 20, 9, 17])


def test_engine_logits_match_the_reference_forward(tiny, monkeypatch):
    """Every decode step's logits of every active row, through chunked
    prefill (prompts over one to three chunks), GRPO forks that copy the
    leader's conv and SSD rows, and refills of fewer rows than the slots,
    against the reference's full forward of the finished rollout."""
    cfg, p = tiny
    eng = _engine(cfg, p, PROMPTS, cache="paged", page_size=8,
                  paged_attention="kernel")
    seen = []
    raw = M.decode_step

    def decode_step(*a, **k):
        out = raw(*a, **k)
        act = eng._host_active.copy()
        seen.append((eng._slot_rid[act].copy(), a[2][act, 0].clone(),
                     out["logits"][act, 0].clone()))
        return out

    monkeypatch.setattr(M, "decode_step", decode_step)
    done = {r.rid: r for r in _drain(eng)}
    # the third group's copies enter in two refills, a leader in each
    assert len(done) == len(PROMPTS) and eng.prefix_forks == 10
    # some refill ran fewer rows than the 10 slots
    assert eng.prefill_row_tokens < 10 * 8 * eng.prefill_invocations
    ref = ARCH.Model(TINY, p)
    want = {}
    for rid, r in done.items():
        tok = torch.as_tensor(r.tokens, dtype=torch.long)[None]
        hn, _ = ref.hidden(tok)
        want[rid] = (hn @ p["lm_head"])[0]
    n = 0
    for rids, pos, logits in seen:
        for rid, q, row in zip(rids.tolist(), pos.tolist(), logits):
            torch.testing.assert_close(row, want[rid][q], rtol=0, atol=2e-5)
            n += 1
    assert n == sum(len(r.tokens) - r.prompt_len for r in done.values())


def test_paged_equals_slots_bit_for_bit(tiny):
    """The paged engine (prefix forks, the paged kernel's path) and the
    slot engine (every copy prefilled) give the same tokens and logprobs
    bit for bit, and the same conv and SSD rows after the first refill."""
    cfg, p = tiny
    slots = _engine(cfg, p, PROMPTS)
    paged = _engine(cfg, p, PROMPTS, cache="paged", page_size=8,
                    paged_attention="kernel")
    assert slots.refill() == paged.refill() == 10
    for k in ("conv", "ssd"):
        assert torch.equal(paged.state["cache"][k], slots.state["cache"][k])
    a = {r.rid: r for r in _drain(slots)}
    b = {r.rid: r for r in _drain(paged)}
    assert sorted(a) == sorted(b) == list(range(len(PROMPTS)))
    assert paged.prefix_forks > 0 and slots.prefix_forks == 0
    for rid, x in a.items():
        np.testing.assert_array_equal(b[rid].tokens, x.tokens)
        np.testing.assert_array_equal(b[rid].behavior_logprobs,
                                      x.behavior_logprobs)
