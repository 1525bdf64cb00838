"""The one generator of the benchmark's traffic: it reads a mix's
parameters (a `traffic/<mix>.json` file) and the run's seed, and makes
the prompts or rollouts the drivers feed the program.

Every seed draws the same sizes in the same order: prompt lengths come
from a fixed grid over [len_min, len_max] (`len_grid` points), taken
from its two ends in turn (shortest, longest, second shortest, second
longest, ...) round after round, so any two consecutive GRPO groups have
prompts that sum to len_min + len_max and no run of long or short prompts
forms. With no end-of-sequence sampled, lengths alone set the engine's
schedule, so every run of a cell does the same work; the seed draws the
token ids, the weights and the engine's samples. Token ids are uniform in [id_min,
vocab): never the pad (0) nor the end-of-sequence id (2).
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Tuple

import numpy as np


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def prompt_lengths(spec: Dict) -> Iterator[int]:
    """Endless prompt lengths: the grid from its two ends in turn, round
    after round."""
    grid = np.rint(np.linspace(spec["len_min"], spec["len_max"],
                               spec["len_grid"])).astype(int)
    n = len(grid)
    order = [grid[i // 2] if i % 2 == 0 else grid[n - 1 - i // 2]
             for i in range(n)]
    while True:
        for length in order:
            yield int(length)


def grpo_prompts(spec: Dict, seed: int,
                 vocab: int) -> Iterator[Tuple[int, List[int]]]:
    """Endless (group ordinal, prompt ids) in GRPO groups: each prompt
    `group` times in a row."""
    lengths = prompt_lengths(spec)
    rng = seed_rng(seed, 2)
    for g in itertools.count():
        ids = rng.integers(spec["id_min"], vocab, next(lengths)).tolist()
        for _ in range(spec["group"]):
            yield g, ids


def rollout_groups(spec: Dict, seed: int, vocab: int) -> Iterator[Dict]:
    """Endless finished rollouts for a trainer fed without an engine, one
    GRPO group at a time: `group` rollouts that share a prompt, each
    completed with random ids to `length` tokens, with behavior logprobs
    drawn near -log(vocab), a version lag in [0, lag_max] and a task
    reward in {0, 1}."""
    lengths = prompt_lengths(spec)
    rng = seed_rng(seed, 3)
    T = spec["length"]
    while True:
        P = next(lengths)
        prompt = rng.integers(spec["id_min"], vocab, P)
        rows = []
        for _ in range(spec["group"]):
            toks = np.concatenate(
                [prompt, rng.integers(spec["id_min"], vocab, T - P)])
            beh = np.zeros(T, np.float32)
            beh[P:] = (-np.log(vocab) + spec["beh_sd"]
                       * rng.standard_normal(T - P)).astype(np.float32)
            rows.append({"tokens": toks.astype(np.int32), "prompt_len": P,
                         "beh": np.minimum(beh, 0.0),
                         "lag": int(rng.integers(0, spec["lag_max"] + 1)),
                         "reward": float(rng.integers(0, 2))})
        yield {"prompt_len": P, "rows": rows}
