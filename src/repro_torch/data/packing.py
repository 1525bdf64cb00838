"""The finished-rollout record the generation engine returns, and online
sequence packing (paper §4, 'online sequence packing for fast training').

Finished rollouts of ragged length are packed greedily (first-fit) into
fixed (B, S) training rows; `segment_ids` prevent cross-sequence attention,
`positions` restart per segment, and `loss_mask` covers completion tokens
only. Host numpy, byte for byte the JAX package's `pack`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Rollout:
    """One finished sequence from the generation engine."""
    tokens: np.ndarray             # (T,) prompt + completion
    prompt_len: int
    behavior_logprobs: np.ndarray  # (T,) 0 for prompt positions
    reward: float
    weight_versions: np.ndarray    # (T,) trainer version each token was sampled under
    finished_at: float = 0.0       # sim-clock timestamp (lag bookkeeping)
    prompt_key: int = 0            # prompt identity (group-relative baseline)
    ref_logprobs: Optional[np.ndarray] = None   # filled by the Preprocessor
    token_rewards: Optional[np.ndarray] = None  # KL-shaped per-token rewards
    slot: int = -1                 # engine slot that produced this rollout
    truncated: bool = False        # hit max_len without emitting EOS
    rid: int = -1                  # the engine's id of its admission

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])


def pack(rollouts: List[Rollout], batch: int, seq: int,
         pad_id: int = 0, trainer_version: Optional[int] = None,
         max_lag: Optional[int] = None) -> Dict[str, np.ndarray]:
    """First-fit pack rollouts into (batch, seq) rows. Sequences longer than
    `seq` are truncated; rows that stay empty are fully masked.

    Two phases: a cheap placement pass (first-fit row search over running
    row occupancy — pure python ints), then one batched copy per row per
    field — each row's segments are concatenated and written with a single
    slice assign, instead of 7 separate (T,) scatter assignments per
    rollout (the old inner loop dominated pack() time at engine-scale
    rollout counts).

    When `trainer_version` is given (the version the learner will step
    *from*, i.e. `trainer.version` at batch-assembly time), the batch also
    carries the staleness contract: per-token `lag = trainer_version -
    weight_versions` on completion positions (0 on prompt/pad, clipped at
    0 so a post-rollback batch can't go negative) and a per-segment
    `truncated` flag. With `max_lag` set, completion tokens whose lag
    exceeds the bound are masked out of the loss and counted in
    `packing_stats["lag_masked"]` — the hard half of the periodic-
    asynchrony barrier (the actor-side gate throttles new stale sampling;
    this guarantees no over-bound token is ever trained on)."""
    tokens = np.full((batch, seq), pad_id, np.int32)
    segment_ids = np.zeros((batch, seq), np.int32)
    positions = np.zeros((batch, seq), np.int32)
    loss_mask = np.zeros((batch, seq), np.float32)
    behavior_lp = np.zeros((batch, seq), np.float32)
    rewards = np.zeros((batch, seq), np.float32)   # per-token (broadcast of seq reward)
    versions = np.zeros((batch, seq), np.int32)
    with_lag = trainer_version is not None
    if with_lag:
        lag = np.zeros((batch, seq), np.int32)
        trunc = np.zeros((batch, seq), np.float32)
    used = np.zeros(batch, np.int32)
    dropped = 0

    # ---- placement: first-fit row per rollout --------------------------
    per_row: List[List[Rollout]] = [[] for _ in range(batch)]
    for r in rollouts:
        T = min(r.length, seq)
        row = -1
        for b in range(batch):
            if used[b] + T <= seq:
                row = b
                break
        if row < 0:
            dropped += 1
            continue
        per_row[row].append(r)
        used[row] += T

    # ---- one batched copy per row per field ----------------------------
    for b, rs in enumerate(per_row):
        if not rs:
            continue
        Ts = [min(r.length, seq) for r in rs]
        n = int(np.sum(Ts))
        tokens[b, :n] = np.concatenate([r.tokens[:T] for r, T in zip(rs, Ts)])
        segment_ids[b, :n] = np.repeat(np.arange(1, len(rs) + 1), Ts)
        positions[b, :n] = np.concatenate([np.arange(T) for T in Ts])
        # loss on completion tokens only (prediction targets are shifted in
        # the trainer; the mask marks *sampled* positions)
        loss_mask[b, :n] = np.concatenate(
            [(np.arange(T) >= min(r.prompt_len, T)).astype(np.float32)
             for r, T in zip(rs, Ts)])
        behavior_lp[b, :n] = np.concatenate(
            [r.behavior_logprobs[:T] for r, T in zip(rs, Ts)])
        rewards[b, :n] = np.concatenate(
            [r.token_rewards[:T] if r.token_rewards is not None
             else np.full(T, r.reward, np.float32) for r, T in zip(rs, Ts)])
        versions[b, :n] = np.concatenate(
            [r.weight_versions[:T] for r, T in zip(rs, Ts)])
        if with_lag:
            # lag only on completion positions (prompt stamps are 0 by
            # engine convention, not a real sampling version)
            lag[b, :n] = np.maximum(
                trainer_version - versions[b, :n], 0
            ).astype(np.int32) * (loss_mask[b, :n] > 0)
            trunc[b, :n] = np.concatenate(
                [np.full(T, float(r.truncated), np.float32)
                 for r, T in zip(rs, Ts)])

    lag_masked = 0
    if with_lag and max_lag is not None:
        over = (lag > max_lag) & (loss_mask > 0)
        lag_masked = int(over.sum())
        loss_mask = np.where(over, 0.0, loss_mask).astype(np.float32)

    out = {
        "tokens": tokens,
        "segment_ids": segment_ids,
        "positions": positions,
        "loss_mask": loss_mask,
        "behavior_logprobs": behavior_lp,
        "rewards": rewards,
        "weight_versions": versions,
        "packing_stats": {
            "fill": float(used.sum()) / float(batch * seq),
            "dropped": dropped,
        },
    }
    if with_lag:
        out["lag"] = lag
        out["truncated"] = trunc
        out["packing_stats"]["lag_masked"] = lag_masked
    return out
