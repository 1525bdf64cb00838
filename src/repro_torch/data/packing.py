"""The finished-rollout record the generation engine returns. Online
sequence packing (`pack`) is ported with the training slice."""
from __future__ import annotations

import dataclasses
from typing import Optional

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

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])
