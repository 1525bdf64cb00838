"""DeepSeek-V3 (MLA, a leading dense layer, MoE, the MTP head) through the
port's engine, Preprocessor and Trainer against the JAX package's, on the
CPU.

Config: `smoke_config(get_config("deepseek-v3-671b"))` (see
`test_torch_mla.py`) with the math task's vocab, float32; the same
converted weights and numpy inputs in both packages.

The engines run at temperature 1e-6 (greedy) and each is held to the JAX
engine in its own admission mode: the MoE capacity is shared by every row
of a call (ROADMAP.md C.9), so chunked admission need not equal the token
loop. Tolerances, float32: equal tokens and stamps, behavior logprobs
within atol 1e-5 (as `test_torch_moe.py`); the paged engines' prefix-shared
forks (the leader's latent pages, copied on write at the divergence block)
and `recompute_kv` likewise; the Preprocessor's reference logprobs within
atol and rtol 2e-4 and its rewards within 2e-5, one Trainer step's metrics
within 1e-5 and its params as `test_torch_moe.py` holds them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config
from repro.core.preprocess import PreprocessConfig as JaxPreprocessConfig
from repro.core.preprocess import Preprocessor as JaxPreprocessor
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.core.rollout import GenerationEngine as JaxEngine
from repro.core.trainer import Trainer as JaxTrainer
from repro.data.math_task import MathTask as JaxTask
from repro.data.math_task import Problem as JaxProblem
from repro.data.packing import Rollout as JaxRollout
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro.sharding import tree_values
from repro_torch import (AdamConfig, EngineConfig, GenerationEngine,
                         PreprocessConfig, Preprocessor, Trainer, get_config)
from repro_torch.convert import params_from_numpy
from repro_torch.core.weights import tree_flatten
from repro_torch.data.math_task import MathTask, Problem
from repro_torch.data.packing import Rollout, pack

JTASK, TASK = JaxTask(max_operand=5, ops="+"), MathTask(max_operand=5, ops="+")
VOCAB = TASK.tok.vocab_size
ATOL = 1e-5
CPU = {"device": "cpu"}
LENGTHS = [5, 11, 7, 14, 9, 6]


def _configs(**kw):
    jcfg = dataclasses.replace(smoke_config(jax_get_config(
        "deepseek-v3-671b")), vocab_size=VOCAB, **kw)
    tcfg = get_config("deepseek-v3-671b")
    same = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcfg)
            if f.name != "dtype"}
    return jcfg, dataclasses.replace(tcfg, dtype=torch.float32, **same)


@functools.lru_cache(maxsize=None)
def _numpy_tree(seed):
    return jax.tree.map(np.asarray, tree_values(
        JM.init_params(_configs()[0], jax.random.PRNGKey(seed))))


def _params(tcfg, seed=0):
    tree = _numpy_tree(seed)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, **CPU))


def _prompts(lengths, seed=0, copies=1):
    rng = np.random.default_rng(seed)
    ids = [[1] + rng.integers(3, VOCAB, n - 1).tolist() for n in lengths]
    ids = [p for p in ids for _ in range(copies)]
    return ([JaxProblem(list(p), 0) for p in ids],
            [Problem(list(p), 0) for p in ids])


def _source(problems):
    it = iter(list(problems))
    return lambda: next(it, None)


def _run(jeng, teng, steps=300, at=None):
    """Refill and step both engines in lockstep until both are idle;
    `at(step)` runs before each step. Returns both rollout lists."""
    jout, tout = [], []
    for i in range(steps):
        assert jeng.refill() == teng.refill()
        if jeng.n_active == 0 and teng.n_active == 0:
            break
        if at is not None:
            at(i)
        jout += jeng.step(JTASK)
        tout += teng.step(TASK)
    return jout, tout


def _same(jout, tout, n):
    assert len(tout) == len(jout) == n
    for a, b in zip(jout, tout):
        assert a.slot == b.slot and a.prompt_len == b.prompt_len
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.weight_versions, a.weight_versions)
        np.testing.assert_allclose(b.behavior_logprobs, a.behavior_logprobs,
                                   atol=ATOL, rtol=0)


def _engines(tcfg, jp, tp, ec, jprobs, tprobs, seed=1):
    jeng = JaxEngine(_configs()[0], jp, JaxEngineConfig(**ec),
                     _source(jprobs), seed=seed)
    teng = GenerationEngine(tcfg, tp, EngineConfig(**ec), _source(tprobs),
                            seed=seed, **CPU)
    return jeng, teng


@pytest.mark.parametrize("cache,chunk", [("slots", 4), ("slots", 0),
                                         ("paged", 4)])
def test_greedy_engine_matches_jax(cache, chunk):
    """Chunked (4-token chunks) and legacy admission on the slot cache, and
    chunked on the page pool (page 8), each against the JAX engine in the
    same mode: every rollout, the token and prefill counts, and the
    latent cache leaves the engine allocates."""
    _, tcfg = _configs()
    jp, tp = _params(tcfg)
    jprobs, tprobs = _prompts(LENGTHS)
    ec = dict(n_slots=3, max_len=24, prefill_chunk=chunk, temperature=1e-6,
              cache=cache, page_size=8)
    jeng, teng = _engines(tcfg, jp, tp, ec, jprobs, tprobs)
    assert set(teng.state["cache"]) == {"c_kv", "k_rope"}
    assert teng._cache_len == jeng._cache_len == 24
    _same(*_run(jeng, teng), len(LENGTHS))
    assert teng.tokens_generated == jeng.tokens_generated
    assert teng.prefill_invocations == jeng.prefill_invocations
    if cache == "paged":
        assert teng.allocator.live_pages == jeng.allocator.live_pages == 0


def test_prefix_sharing_forks_match_jax():
    """Two GRPO groups of 3 identical prompts on paged engines with prefix
    sharing: one prefill per group, the forks read the leader's latent
    pages and copy the shared block on their first write, and every
    rollout equals the JAX paged engine's."""
    _, tcfg = _configs()
    jp, tp = _params(tcfg)
    jprobs, tprobs = _prompts([7, 10], seed=8, copies=3)
    ec = dict(n_slots=6, max_len=24, prefill_chunk=4, temperature=1e-6,
              cache="paged", page_size=8, prefix_sharing=True)
    jeng, teng = _engines(tcfg, jp, tp, ec, jprobs, tprobs, seed=5)
    jout, tout = _run(jeng, teng)
    assert teng.prompt_prefills == jeng.prompt_prefills == 2
    assert teng.prefix_forks == jeng.prefix_forks == 4
    assert teng.pages_copied == jeng.pages_copied > 0
    _same(jout, tout, 6)
    assert teng.allocator.live_pages == 0


@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_recompute_kv_matches_jax(cache):
    """A `recompute_kv` weight update after three decode steps (the paged
    engines unshare their pages first): the rollouts that follow equal the
    JAX engine's."""
    _, tcfg = _configs()
    jp, tp = _params(tcfg)
    jp2, tp2 = _params(tcfg, seed=1)
    jprobs, tprobs = _prompts(LENGTHS[:3])
    ec = dict(n_slots=3, max_len=24, prefill_chunk=4, temperature=1e-6,
              cache=cache, page_size=8)
    jeng, teng = _engines(tcfg, jp, tp, ec, jprobs, tprobs)

    def swap(i):
        if i == 3:
            jeng.set_weights(jp2, 1, recompute_kv=True)
            teng.set_weights(tp2, 1, recompute_kv=True)

    _same(*_run(jeng, teng, at=swap), 3)
    assert teng.version == jeng.version == 1


def _rollouts(n, seed=0, max_len=30):
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(n):
        L = int(rng.integers(8, max_len))
        pl = int(rng.integers(2, 6))
        lp = np.where(np.arange(L) >= pl, -rng.random(L) * 3, 0)
        fields.append(dict(
            tokens=rng.integers(0, VOCAB, L).astype(np.int32), prompt_len=pl,
            behavior_logprobs=lp.astype(np.float32),
            reward=float(rng.integers(0, 2)),
            weight_versions=np.zeros(L, np.int32), truncated=False))
    return ([JaxRollout(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                           for k, v in f.items()}) for f in fields],
            [Rollout(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                        for k, v in f.items()}) for f in fields])


def test_preprocessor_matches_jax():
    """The fused forward, whose MTP stats pass through unread: reference
    logprobs and the KL-shaped rewards."""
    jcfg, tcfg = _configs(fused_loss=True)
    jp, tp = _params(tcfg)
    jr, tr = _rollouts(4, seed=2)
    JaxPreprocessor(jcfg, jp, JaxPreprocessConfig(
        kl_coef=0.05, max_len=32)).process(jr)
    Preprocessor(tcfg, tp, PreprocessConfig(kl_coef=0.05, max_len=32),
                 **CPU).process(tr)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.ref_logprobs, b.ref_logprobs,
                                   atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(a.token_rewards, b.token_rewards,
                                   atol=2e-5, rtol=0)


def test_trainer_step_matches_jax():
    """One step on a packed batch with the fused loss and remat: the MTP
    head's outputs take no part in the loss, so its leaves get a zero
    gradient in both packages and stay as they were; metrics within 1e-5
    (moe_aux within 1e-6), params within 1e-6 but for at most 0.1% of a
    leaf's elements (at least one), all within 5e-5."""
    jcfg, tcfg = _configs(fused_loss=True, remat=True)
    jp, tp = _params(tcfg)
    jtr = JaxTrainer(jcfg, jp, adam=JaxAdamConfig(lr=1e-3))
    ttr = Trainer(tcfg, tp, adam=AdamConfig(lr=1e-3), **CPU)
    batch = pack(_rollouts(6, seed=7)[1], batch=2, seq=64)
    jm = dict(jtr.step(dict(batch)))
    tm = dict(ttr.step(dict(batch)))
    assert set(jm) == set(tm) and "moe_aux" in tm
    assert ttr.version == jtr.version == 1
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=0,
                                   atol=1e-6 if k == "moe_aux" else 1e-5,
                                   err_msg=k)
    for a, b in zip(tree_flatten(ttr.params["mtp"])[0],
                    tree_flatten(tp["mtp"])[0]):
        assert torch.equal(a, b)
    assert not torch.equal(ttr.params["groups"][0]["attn"]["wkv_a"],
                           tp["groups"][0]["attn"]["wkv_a"])
    for a, b in zip(tree_flatten(ttr.params)[0], jax.tree.leaves(jtr.params)):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert (np.abs(a - b) > 1e-6).sum() <= max(1, 1e-3 * a.size)
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)
