"""The plain float32 reference of the RL step: the Preprocessor's reward
shaping, the truncated-IS REINFORCE loss with the value baseline, the
gradient-norm clip and Adam. Each rollout is its own row (packing only
places rollouts side by side; attention never crosses them), so no
packing is needed. Imports nothing of the program.

The equations follow the port's `Preprocessor.process`, `reinforce_loss`
(lag_mode "off") and `adam_update`:
- token rewards r_t = R / n * m_t - beta (beh_t - ref_t) m_t, with m_t = 1
  on completion positions and n their count (the GRPO group baseline is
  applied after the Preprocessor has set token rewards, which the packed
  batch then carries, so it does not reach the loss);
- loss = -mean_m(min(exp(cur - beh), clamp) * (r - v) * cur)
         + value_coef * mean_m((r - v)^2) + aux_coef * aux (the
  architecture's aux loss, a zero where it has none),
  the means over every completion token of the batch;
- Adam: g scaled by min(1, clip / (|g| + 1e-9)), m = b1 m + (1 - b1) g,
  v = b2 v + (1 - b2) g^2, p -= lr m_hat / (sqrt(v_hat) + eps).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from rlbench import arch
from rlbench.weights import leaves, tree_of


def token_rewards(reward: torch.Tensor, beh, ref, mask, kl_coef: float):
    """(B, S) KL-shaped per-token rewards from per-row task rewards (B,)."""
    n = mask.sum(1, keepdim=True).clamp(min=1.0)
    return reward[:, None] / n * mask - kl_coef * (beh - ref) * mask


def shifted_logprobs(model, hn, tokens, rows: int):
    """Per-position logprob of each token under the prefix before it (0 at
    position 0), as the port aligns `token_logprobs`."""
    tgt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    lp = model.token_logprobs(hn, tgt, rows)
    return torch.cat([torch.zeros_like(lp[:, :1]), lp[:, :-1]], dim=1)


def loss_of(model, batch: Dict[str, torch.Tensor], rl: Dict,
            rows: int = 1) -> torch.Tensor:
    """The loss of one optimizer step on `batch` (rows = rollouts)."""
    tokens, mask = batch["tokens"], batch["mask"]
    hn, aux = model.hidden(tokens, remat=True)
    cur = shifted_logprobs(model, hn, tokens, rows)
    values = model.values(hn)
    r = batch["rewards"]
    denom = mask.sum().clamp(min=1.0)
    ratio = torch.exp(torch.where(mask > 0, cur - batch["beh"],
                                  torch.zeros_like(cur)))
    clamped = torch.clamp(ratio, max=rl["is_clamp"]).detach()
    adv = (r - values).detach()
    pg = -(clamped * adv * cur * mask).sum() / denom
    value_loss = ((r - values) ** 2 * mask).sum() / denom
    # the architecture's aux loss: a zero tensor where it has none
    return pg + rl["value_coef"] * value_loss + rl["aux_coef"] * aux


class Adam:
    """Adam over the float32 leaves of a reference model."""

    def __init__(self, params: List[torch.Tensor], opt: Dict):
        self.p = params
        self.o = opt
        self.m = [torch.zeros_like(x) for x in params]
        self.v = [torch.zeros_like(x) for x in params]
        self.t = 0

    def step(self, grads: List[torch.Tensor]) -> float:
        """Returns the global gradient norm (before the clip)."""
        o = self.o
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = min(1.0, o["grad_clip"] / (float(norm) + 1e-9))
        self.t += 1
        b1c = 1.0 - o["b1"] ** self.t
        b2c = 1.0 - o["b2"] ** self.t
        with torch.no_grad():
            for p, g, m, v in zip(self.p, grads, self.m, self.v):
                g = g * scale
                m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
                p.sub_(o["lr"] * (m / b1c) / (torch.sqrt(v / b2c) + o["eps"]))
        return float(norm)


def _through(f):
    """`f` in the forward with the gradient passed straight through it."""
    return f and (lambda x: x + (f(x) - x).detach())


def train_steps(c: Dict, p32: Dict, batches: List[Dict[str, torch.Tensor]],
                rl: Dict, opt: Dict, rows: int = 1, quant=None,
                act=None) -> Dict:
    """Runs the steps of `batches` from the float32 weights `p32` (updated
    in place). Returns each step's loss and global gradient norm, and the
    first step's first Adam moment and gradient by leaf (name -> norm).
    `quant`, when given, rounds every weight as the forward reads it (a
    layer's slice, `Model.weight`) and `act` every input of a weight
    product; the gradient passes straight through both."""
    names, ps = zip(*leaves(p32, c))
    for x in ps:
        x.requires_grad_(False)
    adam = Adam(list(ps), opt)
    out = {"loss": [], "grad_norm": [], "m1": {}}
    for i, batch in enumerate(batches):
        for x in ps:
            x.requires_grad_(True)
        model = arch.model(c, tree_of(c, list(ps)), act=_through(act),
                           quant=_through(quant))
        loss = loss_of(model, batch, rl, rows)
        grads = torch.autograd.grad(loss, ps)
        for x in ps:
            x.requires_grad_(False)
        out["loss"].append(float(loss.detach()))
        out["grad_norm"].append(adam.step(list(grads)))
        if i == 0:
            out["m1"] = {n: float(m.norm()) for n, m in zip(names, adam.m)}
            out["g1"] = {n: float(g.norm()) for n, g in zip(names, grads)}
        del grads, loss, model
    return out
