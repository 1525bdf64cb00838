"""The traffic generator: the same seed gives the same traffic, and every
seed the same prompt lengths in the same order, taken from the grid's two
ends in turn."""
import itertools
import json
from pathlib import Path

import pytest

from rlbench import traffic

ROOT = Path(__file__).resolve().parent.parent
MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "rlbench/traffic").glob("*.json")}
SEEDS = (0, 2 ** 31 + 11, 3 * 10 ** 9 + 7)


def draw(mix, seed, n):
    if "prompts" in mix:
        gen = traffic.grpo_prompts(mix["prompts"], seed, 49155)
        return [(g, tuple(ids)) for g, ids in itertools.islice(gen, n)]
    gen = traffic.rollout_groups(mix["rollouts"], seed, 49155)
    return [(g["prompt_len"], tuple(r["tokens"]), tuple(r["beh"]), r["lag"],
             r["reward"]) for g in itertools.islice(gen, n // 8)
            for r in g["rows"]]


@pytest.mark.parametrize("name", sorted(MIXES))
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_traffic(name, seed):
    a, b = draw(MIXES[name], seed, 64), draw(MIXES[name], seed, 64)
    assert a == b
    assert a != draw(MIXES[name], seed + 1, 64)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_draws_the_same_lengths(name):
    mix = MIXES[name]
    spec = mix.get("prompts") or mix["rollouts"]
    n = spec["len_grid"]
    lens = list(itertools.islice(traffic.prompt_lengths(spec), 3 * n))
    assert lens[:n] == lens[n:2 * n] and len(set(lens[:n])) == n
    assert min(lens) == spec["len_min"] and max(lens) == spec["len_max"]
    # two consecutive groups' prompts sum to the ends of the range
    assert {a + b for a, b in zip(lens[:n:2], lens[1:n:2])} \
        == {spec["len_min"] + spec["len_max"]}
    if "prompts" in mix:
        got = [[len(ids) for _, ids in itertools.islice(
            traffic.grpo_prompts(spec, s, 49155), 0, 8 * n, 8)]
            for s in SEEDS]
    else:
        got = [[g["prompt_len"] for g in itertools.islice(
            traffic.rollout_groups(spec, s, 49155), n)] for s in SEEDS]
    assert got[0] == got[1] == got[2] == lens[:n]


def test_ids_avoid_pad_and_eos():
    mix = MIXES["loop-grpo512"]
    for g, ids in itertools.islice(
            traffic.grpo_prompts(mix["prompts"], 5, 49155), 40):
        assert min(ids) >= 3 and max(ids) < 49155
    spec = MIXES["train-pack4096"]["rollouts"]
    for grp in itertools.islice(traffic.rollout_groups(spec, 5, 49155), 3):
        for r in grp["rows"]:
            assert len(r["tokens"]) == spec["length"]
            assert (r["beh"] <= 0).all() and r["tokens"].min() >= 3
            assert (r["beh"][:grp["prompt_len"]] == 0).all()
