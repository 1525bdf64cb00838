"""The plain reference against the port's own plain path (the kernels'
plain versions on the CPU), at a tiny size, on the benchmark's weights:
logits, the RL loss and its gradients, one Adam step; for every
configuration file, whatever its architecture."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from rlbench import arch, harness, port, rehearse, weights
from rlbench.reference import rl

CONFIGS = sorted(p.stem for p in (Path(__file__).resolve().parent
                                  / "configs").glob("*.json"))


def tiny(name):
    return rehearse.tiny_config(
        harness.load_config(f"rlbench/configs/{name}.json"))


def batch(c, seed=0, B=3, S=24, P=7):
    rng = np.random.default_rng(seed)
    tok = rng.integers(3, c["vocab_size"], (B, S))
    mask = np.zeros((B, S), np.float32)
    mask[:, P:] = 1
    beh = np.where(mask > 0, -np.log(c["vocab_size"])
                   + 0.3 * rng.standard_normal((B, S)), 0).astype(np.float32)
    rewards = (rng.standard_normal((B, S)) * mask).astype(np.float32)
    return tok, mask, beh, rewards


@pytest.mark.parametrize("name", CONFIGS)
def test_logits_match_port(name):
    from repro_torch.models import model as M
    c = tiny(name)
    with rehearse.tiny_port(c):
        cfg = port.config(c, "cpu")
    p = weights.make_params(c, 3, "cpu")
    tok = torch.as_tensor(batch(c)[0])
    pos = torch.arange(tok.shape[1])[None].expand_as(tok)
    want = M.forward(p, tok, pos, dataclasses.replace(cfg, fused_loss=False))
    ref = arch.model(c, p)
    hn, aux = ref.hidden(tok)
    got = hn @ p["lm_head"]
    torch.testing.assert_close(got, want["logits"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(aux, want["aux_loss"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_grads_and_adam_match_port(name):
    from repro_torch.core.algo import RLConfig
    from repro_torch.core.trainer import init_train_state, train_step
    from repro_torch.optim.adam import AdamConfig
    c = tiny(name)
    with rehearse.tiny_port(c):
        cfg = port.config(c, "cpu")
    t = harness.load_json("rlbench/traffic/train-pack4096.json")
    tok, mask, beh, rewards = batch(c, 1)
    p = weights.make_params(c, 4, "cpu")
    B, S = tok.shape
    pb = {"tokens": torch.as_tensor(tok),
          "positions": torch.arange(S)[None].expand(B, S),
          "segment_ids": torch.ones(B, S, dtype=torch.long),
          "loss_mask": torch.as_tensor(mask),
          "behavior_logprobs": torch.as_tensor(beh),
          "rewards": torch.as_tensor(rewards)}
    st = init_train_state(p, device="cpu")
    new, m = train_step(st, pb, cfg, RLConfig(**t["rl"]),
                        AdamConfig(**t["adam"]))
    p32 = weights.make_params(c, 4, "cpu", dtype=torch.float32)
    rb = {"tokens": pb["tokens"], "mask": pb["loss_mask"],
          "beh": pb["behavior_logprobs"], "rewards": pb["rewards"]}
    got = rl.train_steps(c, p32, [rb], t["rl"], t["adam"])
    assert abs(got["loss"][0] - float(m["loss"])) < 1e-5
    assert abs(got["grad_norm"][0] - float(m["grad_norm"])) \
        < 1e-4 * float(m["grad_norm"])
    # Adam's first step moves each weight by lr g / (|g| + eps): where |g|
    # is near eps, the rounding of g in either sum moves it by a few
    # thousandths of lr at most
    for (n, a), (_, b) in zip(weights.leaves(p32, c),
                              weights.leaves(new.params, c)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5, msg=n)
    for n, mt in weights.leaves(new.opt.m, c):
        assert abs(float(mt.norm()) - got["m1"][n]) \
            <= 1e-4 * got["m1"][n] + 1e-9
