"""Synthetic math reasoning task (stand-in for OpenReasoner-Zero's 17K
problems): arithmetic expressions the policy must answer after '='.

Reward follows the paper: 1 for a correct answer, 0 otherwise, plus a soft
penalty as the generation approaches the maximum sequence length.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenizer import CharTokenizer


@dataclasses.dataclass
class Problem:
    prompt_ids: List[int]
    answer: int


class MathTask:
    def __init__(self, max_operand: int = 20, ops: str = "+-", seed: int = 0,
                 partial_credit: bool = False):
        """partial_credit=True adds dense shaping for the CPU testbed (a
        well-formed short numeric answer earns 0.25 even when wrong) —
        exact-match-only reward is too sparse for a char-level model trained
        from scratch in a few hundred steps."""
        self.tok = CharTokenizer()
        self.max_operand = max_operand
        self.ops = ops
        self.partial_credit = partial_credit
        self.rng = np.random.RandomState(seed)

    def sample(self) -> Problem:
        a = int(self.rng.randint(0, self.max_operand))
        b = int(self.rng.randint(0, self.max_operand))
        op = self.ops[int(self.rng.randint(len(self.ops)))]
        ans = a + b if op == "+" else (a - b if op == "-" else a * b)
        text = f"{a}{op}{b}="
        return Problem(self.tok.encode(text, bos=True), ans)

    def sample_batch(self, n: int) -> List[Problem]:
        return [self.sample() for _ in range(n)]

    def reward(self, problem: Problem, completion_ids: Sequence[int],
               max_new_tokens: int, soft_penalty_margin: int = 4) -> float:
        """1.0 if the completion spells the correct integer (then EOS),
        0.0 otherwise; soft penalty near the length limit (paper §5)."""
        text = self.tok.decode(completion_ids).strip()
        # cut at first non-digit/non-sign character
        body = ""
        for i, ch in enumerate(text):
            if ch.isdigit() or (ch == "-" and i == 0):
                body += ch
            else:
                break
        correct = False
        well_formed = False
        if body not in ("", "-"):
            try:
                correct = int(body) == problem.answer
                well_formed = body == text  # nothing but the number
            except ValueError:
                correct = False
        r = 1.0 if correct else 0.0
        if not correct and self.partial_credit and well_formed \
                and len(completion_ids) <= 4:
            r = 0.25  # dense shaping: short, purely-numeric answer
        overrun = len(completion_ids) - (max_new_tokens - soft_penalty_margin)
        if overrun > 0:
            r -= 0.1 * overrun  # soft length penalty
        return float(r)
