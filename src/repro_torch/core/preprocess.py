"""Preprocessor — the middle pipeline stage of the paper's implementation
(Fig. 4): computes reference-model log-probabilities for finished rollouts
and applies the RLHF-style per-token KL penalty

    r_t  <-  r_task/T  -  beta * (log mu(y_t) - log pi_ref(y_t))

before sequences reach the trainer. In the co-simulation it adds its own
stage latency (`stage_time`: a forward pass at tau/3 flashes per token on
its chips).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.core.algo import token_logprobs
from repro_torch.core.weights import tree_flatten
from repro_torch.data.packing import Rollout
from repro_torch.device import resolve_device
from repro_torch.models import model as M


@dataclasses.dataclass
class PreprocessConfig:
    kl_coef: float = 0.0        # beta; 0 disables the KL term
    n_chips: int = 2            # preprocessor workers (sim timing)
    # hard cap on rollout length (the engine's max_len). The ref forward
    # pads each batch to the next power of two of its longest rollout,
    # bounded by this, so a rollout is never clipped to a shorter buffer.
    max_len: int = 64
    fwd_flashes_per_token: float = 4.92 / 3.0  # forward-only share of tau


class Preprocessor:
    """Computes pi_ref token logprobs for rollouts and KL-shapes rewards.
    Runs on the card unless `device="cpu"` is asked for; `ref_params` must
    already live on that device."""

    def __init__(self, cfg: ModelConfig, ref_params, pc: PreprocessConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        for leaf in tree_flatten(ref_params)[0]:
            if leaf.device != self.device:
                raise ValueError(f"ref_params on {leaf.device}, expected "
                                 f"{self.device}")
        self.cfg, self.pc = cfg, pc
        self.ref_params = ref_params

    @torch.no_grad()
    def _ref_logprobs(self, tokens, positions, lengths):
        cfg, T = self.cfg, tokens.shape[1]
        if cfg.fused_loss:
            # the KL penalty needs only the ref logprobs of the rollout's
            # own tokens, the fused-loss contract; the dead last target
            # column is pad, never the row's own last token
            tgt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, -1:])],
                            dim=1)
            lp = M.forward(self.ref_params, tokens, positions, cfg,
                           loss_targets=tgt)["token_logprobs"]
        else:
            out = M.forward(self.ref_params, tokens, positions, cfg)
            lp = token_logprobs(out["logits"], tokens)
        # mask the pad tail: pad-token logprobs in the unfused path, kernel
        # output for pad rows in the fused one; zero in both
        valid = torch.arange(T, device=tokens.device)[None] < lengths[:, None]
        return torch.where(valid, lp, torch.zeros_like(lp))

    @staticmethod
    def _bucket(max_rollout_len: int, cap: int) -> int:
        """Next power of two >= the longest rollout, bounded by `cap`."""
        return min(1 << max(int(max_rollout_len) - 1, 0).bit_length(), cap)

    def process(self, rollouts: List[Rollout]) -> List[Rollout]:
        if not rollouts:
            return rollouts
        with trace.span("pre.process") as sp:
            if sp:
                sp.set(rids=[r.rid for r in rollouts],
                       tokens=sum(r.length for r in rollouts))
            return self._process(rollouts)

    def _process(self, rollouts: List[Rollout]) -> List[Rollout]:
        n = len(rollouts)
        max_len = max(r.length for r in rollouts)
        if max_len > self.pc.max_len:
            raise ValueError(
                f"rollout of length {max_len} exceeds PreprocessConfig."
                f"max_len={self.pc.max_len}; the ref forward would clip it "
                f"and silently drop the KL term on the tail — raise "
                f"max_len to the engine's max_len")
        T = self._bucket(max_len, self.pc.max_len)
        toks = np.zeros((n, T), np.int64)
        lens = np.zeros(n, np.int64)
        for i, r in enumerate(rollouts):
            toks[i, :r.length] = r.tokens
            lens[i] = r.length
        dev = self.device
        pos = torch.arange(T, device=dev)[None].expand(n, T)
        with trace.span("pre.ref_logprobs"):
            ref_lp = self._ref_logprobs(torch.from_numpy(toks).to(dev), pos,
                                        torch.from_numpy(lens).to(dev)
                                        ).cpu().numpy()
        out = []
        for i, r in enumerate(rollouts):
            L = r.length
            r.ref_logprobs = ref_lp[i, :L].copy()
            if self.pc.kl_coef > 0:
                mask = np.arange(L) >= r.prompt_len
                kl = (r.behavior_logprobs[:L] - r.ref_logprobs) * mask
                penalty = np.zeros(L, np.float32)
                penalty[mask] = self.pc.kl_coef * kl[mask]
                n_tok = max(int(mask.sum()), 1)
                r.token_rewards = (np.full(L, r.reward / n_tok, np.float32)
                                   * mask - penalty)
                assert len(r.token_rewards) == r.length
            assert len(r.ref_logprobs) == r.length
            out.append(r)
        return out

    def stage_time(self, n_tokens: int) -> float:
        """Simulated stage latency (flashes) for a batch of tokens."""
        return n_tokens * self.pc.fwd_flashes_per_token / max(
            self.pc.n_chips, 1)
