"""RL algorithm layer: truncated-importance-sampling REINFORCE with a
learned value baseline (paper Eq. 4-5), the ESS on-policyness metric
(Eq. 6, Kong 1992), and lag-aware staleness corrections that consume the
per-token `weight_versions` stamps of the engine:

  lag_mode="off"       — the paper's objective
  lag_mode="token_is"  — per-token lag-conditional clamp: stale tokens get
                         a tighter IS ceiling (clamp decays geometrically
                         in lag)
  lag_mode="truncated" — Truncated-PPO-style staleness horizon: tokens
                         sampled more than `lag_horizon` versions ago are
                         masked out of the objective, and max_len-truncated
                         rollouts can be downweighted (`truncated_weight`)

The modes are Python-time branches, as in the JAX package: a mode never
pays for the others' math, and the armed modes are bitwise "off" whenever
every lag is 0 (`decay**0 == 1`, `mask * 1.0`, `where(True, x, _)`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.layers import pad_before
from repro_torch.shardctx import gather_last


@dataclasses.dataclass(frozen=True)
class RLConfig:
    is_clamp: float = 5.0          # paper: "clamp the importance weights to 5"
    value_coef: float = 0.5
    aux_coef: float = 0.001        # MoE load-balance
    entropy_coef: float = 0.0
    temperature: float = 1.0
    # ---- lag-aware objectives ------------------------------------------
    lag_mode: str = "off"          # "off" | "token_is" | "truncated"
    lag_clamp_decay: float = 0.5   # token_is: clamp *= decay**lag
    lag_clamp_min: float = 1.0     # token_is: clamp floor (>=1 keeps the
                                   # on-policy ratio un-truncated)
    lag_horizon: int = 4           # truncated: mask tokens with lag > this
    truncated_weight: float = 1.0  # truncated: weight for max_len-truncated
                                   # rollouts (1.0 = no downweighting)
    lag_buckets: Tuple[int, ...] = (0, 1, 2, 4, 8)  # per-bucket ESS/clamp


def token_logprobs(logits, tokens):
    """logits: (B,S,V) predicting token t+1 at position t; returns the
    per-token logprob of the sampled token, aligned with `tokens`
    (position 0 gets 0)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp_next = gather_last(lp[:, :-1], tokens[:, 1:, None].long())[..., 0]
    return pad_before(lp_next, 1, 1)


def token_stats_from_logits(logits, tokens):
    """Per-token loss statistics from raw logits, the unfused twin of the
    fused-loss model output: `token_logprobs`, `lse` and `entropy`, each
    (B,S) float32 aligned like `token_logprobs`."""
    l32 = logits.float()
    lse = torch.logsumexp(l32, dim=-1)                          # (B,S)
    tgt_l = gather_last(l32[:, :-1], tokens[:, 1:, None].long())[..., 0]
    p = torch.exp(l32 - lse[..., None])
    ent = lse - torch.sum(p * l32, dim=-1)

    def shift(x):
        return pad_before(x[:, :-1], 1, 1)

    return {"token_logprobs": pad_before(tgt_l - lse[:, :-1], 1, 1),
            "lse": shift(lse), "entropy": shift(ent)}


def _masked_mean(x, mask):
    return torch.sum(x * mask) / torch.clamp(mask.sum(), min=1.0)


def ess(weights, mask) -> torch.Tensor:
    """Normalized effective sample size (Eq. 6) over masked tokens;
    explicitly 0 for an empty mask."""
    w = weights * mask
    n = torch.clamp(mask.sum(), min=1.0)
    s1 = w.sum()
    s2 = torch.square(w).sum()
    return torch.where(s2 > 0,
                       torch.square(s1) / torch.clamp(n * s2, min=1e-30),
                       torch.zeros_like(s2))


def reinforce_loss(outputs, values, batch: Dict[str, torch.Tensor],
                   cfg: RLConfig) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """Truncated-IS REINFORCE (Eq. 5) + value MSE.

    outputs: raw (B,S,V) logits, or a per-token stats dict with
    `token_logprobs` and `entropy` (the fused-loss model output). batch:
    packed train batch (tokens, loss_mask, behavior_logprobs, rewards and,
    with a lag mode armed, `lag` and `truncated`). `values` may be None."""
    tokens, mask = batch["tokens"], batch["loss_mask"]
    stats = outputs if isinstance(outputs, dict) else \
        token_stats_from_logits(outputs, tokens)
    cur_lp = stats["token_logprobs"]                    # (B,S) f32
    beh_lp = batch["behavior_logprobs"]
    rewards = batch["rewards"]

    lag_f = None
    if cfg.lag_mode != "off":
        lag = batch.get("lag")
        lag_f = lag.float() if lag is not None else torch.zeros_like(mask)

    if cfg.lag_mode == "truncated":
        keep = torch.where(lag_f <= float(cfg.lag_horizon), 1.0, 0.0)
        if cfg.truncated_weight != 1.0:
            tr = batch.get("truncated")
            tr = tr.float() if tr is not None else torch.zeros_like(mask)
            keep = keep * (1.0 - (1.0 - cfg.truncated_weight) * tr)
        mask = mask * keep

    log_ratio = torch.where(mask > 0, cur_lp - beh_lp,
                            torch.zeros_like(cur_lp))
    ratio = torch.exp(log_ratio)
    if cfg.lag_mode == "token_is":
        clamp_tok = torch.clamp(
            cfg.is_clamp * torch.pow(cfg.lag_clamp_decay, lag_f),
            min=cfg.lag_clamp_min)
    else:
        clamp_tok = cfg.is_clamp
    clamped = torch.minimum(ratio, torch.as_tensor(clamp_tok,
                                                   dtype=ratio.dtype,
                                                   device=ratio.device))

    if values is not None:
        baseline = values
        value_loss = _masked_mean(torch.square(rewards - values), mask)
    else:
        baseline = torch.zeros_like(rewards)
        value_loss = torch.zeros((), dtype=torch.float32, device=mask.device)
    adv = (rewards - baseline).detach()

    pg = -_masked_mean(clamped.detach() * adv * cur_lp, mask)
    loss = pg + cfg.value_coef * value_loss
    # entropy bonus: the sampled-token surrogate; the full-distribution
    # entropy is a metric
    ent = -_masked_mean(torch.exp(cur_lp) * cur_lp, mask)
    if cfg.entropy_coef:
        loss = loss - cfg.entropy_coef * ent

    # an all-masked batch is a counted zero-loss no-op
    n_tok = mask.sum()
    loss = torch.where(n_tok > 0, loss, torch.zeros_like(loss))

    metrics = {
        "entropy": _masked_mean(stats["entropy"], mask),
        "pg_loss": pg,
        "value_loss": value_loss,
        "ess": ess(ratio, mask),
        "mean_is_weight": _masked_mean(ratio, mask),
        "clip_frac": _masked_mean((ratio > clamp_tok).float(), mask),
        "token_kl": _masked_mean(beh_lp - cur_lp, mask),
        "mean_reward_tok": _masked_mean(rewards, mask),
        "empty_batch": (n_tok == 0).float(),
    }
    if cfg.lag_mode != "off":
        buckets = tuple(cfg.lag_buckets)
        for i, lo in enumerate(buckets):
            hi = buckets[i + 1] if i + 1 < len(buckets) else None
            sel = (lag_f >= lo) if hi is None else \
                ((lag_f >= lo) & (lag_f < hi))
            bmask = mask * sel
            metrics[f"ess_lag{lo}"] = ess(ratio, bmask)
            metrics[f"clamp_lag{lo}"] = _masked_mean(
                (ratio > clamp_tok).float(), bmask)
    return loss, metrics
