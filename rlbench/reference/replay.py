"""The plain reference of the generation engine's logprobs: each rollout
replayed position by position under the weights that the engine held when
it processed that position.

An engine swaps weights between decode steps and keeps the keys and
values it cached under the older weights (the paper's stale cache). So
position p's keys, values and output were computed by the version that
held the engine at the step that read p: the prompt's first P - 1
positions by the version at admission (its prefill), position p >= P - 1
by the version stamped on token p + 1 (the decode step that read p and
sampled p + 1). The replay walks the versions in order: under each it
runs every rollout's positions of that version through all layers against
that rollout's cache of earlier positions, and reads the logprob of the
next token. Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch


def position_versions(n_tokens: int, prompt_len: int, admit_version: int,
                      stamps: np.ndarray) -> np.ndarray:
    """The version that processed each position 0..n_tokens-2."""
    out = np.empty(n_tokens - 1, np.int64)
    out[:prompt_len - 1] = admit_version
    out[prompt_len - 1:] = stamps[prompt_len:n_tokens]
    return out


def replay(c: Dict, model_of: Callable[[int], object],
           rollouts: List[Dict], device) -> List[np.ndarray]:
    """Reference logprobs of tokens P..n-1 of each rollout (dict: tokens,
    prompt_len, admit_version, stamps). `model_of(v)` gives the reference
    model on the float32 weights of version v on `device`; each version is
    asked for once."""
    vers = [position_versions(len(r["tokens"]), r["prompt_len"],
                              r["admit_version"], r["stamps"])
            for r in rollouts]
    caches: List[Dict] = [{} for _ in rollouts]
    out = [np.zeros(len(r["tokens"]) - r["prompt_len"]) for r in rollouts]
    for v in sorted({int(x) for pv in vers for x in pv}):
        model = model_of(v)
        for r, pv, cache, lp in zip(rollouts, vers, caches, out):
            idx = np.nonzero(pv == v)[0]
            if idx.size == 0:
                continue
            lo, hi = int(idx[0]), int(idx[-1]) + 1
            if hi - lo != idx.size:
                raise ValueError("a rollout's versions are not monotone")
            toks = torch.as_tensor(np.asarray(r["tokens"][lo:hi]),
                                   device=device, dtype=torch.long)[None]
            nxt = torch.as_tensor(np.asarray(r["tokens"][lo + 1:hi + 1]),
                                  device=device, dtype=torch.long)[None]
            with torch.no_grad():
                hn, _ = model.hidden(toks, cache=cache, offset=lo)
                got = model.token_logprobs(hn, nxt)[0].double().cpu().numpy()
            # position p scores token p + 1; keep tokens from P on
            P = r["prompt_len"]
            for j, p in enumerate(range(lo, hi)):
                if p + 1 >= P:
                    lp[p + 1 - P] = got[j]
        del model
    return out
