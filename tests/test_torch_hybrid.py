"""The hybrid (Hymba) path of the port against the JAX package's, on the
CPU: the model, the engine (slot and paged, rings, prefix sharing,
`recompute_kv`), the Preprocessor, the Trainer and PipelineRL.

Config: `smoke_config(get_config("hymba-1.5b"))` (2 layers, d 256, 4/4
heads of 32, 16 SSM heads of 32, state 16, chunk 16, float32) with the math
task's vocab, and the port's config with the same fields. Both packages
start from the same converted weights and get the same numpy inputs.

Tolerances, float32:
- model paths and the token-at-a-time (legacy) engine against the JAX
  package: atol 1e-5, as `test_torch_ssm.py`;
- chunked admission against legacy admission, in the port and against
  the JAX legacy loop: behavior logprobs within 1e-4. The chunked SSD sums
  a chunk's inputs in another order than the token loop's recurrence; the
  reference's own chunked-against-sequential hybrid test
  (`test_prefill.py::test_ring_prefill_matches_sequential[hybrid]`) is red
  at its 1e-5 by 1.99e-5 on one logprob of 24, so 1e-4 is the order the
  reference itself shows, with tokens equal;
- paged against slots within the port: bit for bit, prefix-shared forks
  included (their conv and SSD rows are copies of the leader's);
- Preprocessor, Trainer and PipelineRL: those of `test_torch_ssm_engine.py`.

Sampling runs at temperature 1e-6 (greedy; see `test_torch_ssm_engine.py`
for why not 1e-4).
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
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.core.pipeline import PipelineRL as JaxPipelineRL
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
                         PipelineConfig, PipelineRL, PreprocessConfig,
                         Preprocessor, Trainer, get_config)
from repro_torch.configs.base import PORT_OWN_FIELDS, kv_cache_specs
from repro_torch.convert import params_from_numpy
from repro_torch.core.weights import tree_flatten
from repro_torch.data.math_task import MathTask, Problem
from repro_torch.data.packing import Rollout, pack
from repro_torch.models import model as M
from torch_twin import one_thread

JTASK, TASK = JaxTask(max_operand=5, ops="+"), MathTask(max_operand=5, ops="+")
VOCAB = TASK.tok.vocab_size
ATOL = 1e-5
CHUNKED_ATOL = 1e-4
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for the module (`torch_twin.one_thread`)."""
    with one_thread():
        yield


def _configs(**kw):
    jcfg = dataclasses.replace(smoke_config(jax_get_config("hymba-1.5b")),
                               vocab_size=VOCAB, **kw)
    tcfg = get_config("hymba-1.5b")
    same = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcfg)
            if f.name not in ("dtype",) + PORT_OWN_FIELDS}
    return jcfg, dataclasses.replace(tcfg, dtype=torch.float32, **same)


@functools.lru_cache(maxsize=None)
def _numpy_tree(jcfg, seed):
    return jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(seed))))


def _params(jcfg, tcfg, seed=0):
    """The same random weights in both packages. The JAX tree is drawn once
    per parameter layout (the options that change no leaf share it)."""
    base = _configs()[0]
    tree = _numpy_tree(base, seed)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, **CPU))


@pytest.fixture(scope="module")
def hyb():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_value, atol=ATOL, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_value, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    ids = [[1] + rng.integers(3, VOCAB, n - 1).tolist() for n in lengths]
    return ([JaxProblem(list(p), 0) for p in ids],
            [Problem(list(p), 0) for p in ids])


def _source(problems):
    it = iter(list(problems))
    return lambda: next(it, None)


def _drain(eng, task, max_steps=300):
    out = []
    for _ in range(max_steps):
        eng.refill()
        out += eng.step(task)
        if eng.n_active == 0:
            break
    return out


def _by_prompt(rollouts):
    return {tuple(r.tokens[:r.prompt_len]): r for r in rollouts}


def _same(a_out, b_out, atol=ATOL, bitwise=False):
    """Rollouts matched by prompt: equal tokens and stamps, behavior
    logprobs within atol (or bit for bit)."""
    a, b = _by_prompt(a_out), _by_prompt(b_out)
    assert set(a) == set(b) and len(a) > 0
    for key, x in a.items():
        y = b[key]
        np.testing.assert_array_equal(y.tokens, x.tokens)
        np.testing.assert_array_equal(y.weight_versions, x.weight_versions)
        if bitwise:
            np.testing.assert_array_equal(y.behavior_logprobs,
                                          x.behavior_logprobs)
        else:
            np.testing.assert_allclose(y.behavior_logprobs,
                                       x.behavior_logprobs, atol=atol,
                                       rtol=0)


LENGTHS = [5, 11, 7, 14, 9, 6]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_decode_and_prefill_match_jax(hyb):
    """The full-sequence forward with its cache (k, v, conv and ssd in one
    layer), one decode step from that cache, and two prefill chunks with a
    partial admit mask, each against the JAX package's."""
    jcfg, tcfg, jp, tp = hyb
    rng = np.random.default_rng(11)
    toks = rng.integers(0, VOCAB, (2, 32)).astype(np.int32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32)[None], (2, 32))
    S = 31
    jout = JM.forward(jp, jnp.asarray(toks[:, :S]), jnp.asarray(pos[:, :S]),
                      jcfg, return_cache=True)
    out = M.forward(tp, _t(toks[:, :S]).long(), _t(pos[:, :S]).long(), tcfg,
                    return_cache=True)
    _close(out["logits"], jout["logits"])
    _close(out["values"], jout["values"])
    assert float(out["aux_loss"]) == float(jout["aux_loss"]) == 0.0
    assert set(out["cache"]) == set(jout["cache"]) == {"k", "v", "conv",
                                                       "ssd"}
    for k in out["cache"]:
        _close(out["cache"][k], jout["cache"][k], msg=k)
    # decode the 32nd token against a 32-long cache holding the 31
    cache = {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], dim=2)
             if k in ("k", "v") else v for k, v in out["cache"].items()}
    jcache = {k: jnp.concatenate([v, jnp.zeros_like(v[:, :, :1])], axis=2)
              if k in ("k", "v") else v for k, v in jout["cache"].items()}
    jd = JM.decode_step(jp, jnp.asarray(toks[:, S:]), jnp.asarray(pos[:, S:]),
                        jcache, jnp.full((2,), S, jnp.int32), jcfg)
    d = M.decode_step(tp, _t(toks[:, S:]).long(), _t(pos[:, S:]).long(),
                      cache, torch.full((2,), S), tcfg)
    assert d["cache"] is cache
    _close(d["logits"], jd["logits"])
    for k in cache:
        _close(cache[k], jd["cache"][k], msg=k)
    # two 16-token prefill chunks, row 1 not admitted
    plen = np.array([10, 30, 25], np.int32)
    admit = np.array([True, False, True])
    toks3 = rng.integers(0, VOCAB, (3, 32)).astype(np.int32)
    init = {k: rng.standard_normal(shape).astype(np.float32)
            for k, (shape, _) in kv_cache_specs(tcfg, 3, 32).items()}
    tcache = {k: _t(v) for k, v in init.items()}
    jcache = {k: jnp.asarray(v) for k, v in init.items()}
    for off in (0, 16):
        jcache = JM.prefill_chunk(jp, jnp.asarray(toks3), jnp.asarray(plen),
                                  off, jnp.asarray(admit), jcache, jcfg,
                                  chunk=16)
        M.prefill_chunk(tp, _t(toks3).long(), _t(plen).long(), off,
                        _t(admit), tcache, tcfg, chunk=16)
    for k in tcache:
        _close(tcache[k], jcache[k], msg=k)
        np.testing.assert_array_equal(tcache[k][:, 1].numpy(), init[k][:, 1])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

LEGACY_EC = dict(n_slots=3, max_len=24, prefill_chunk=0, temperature=1e-6,
                 page_size=8)


def _legacy_loop(eng, task):
    """Refill and step until nothing is active: (admitted per refill,
    rollouts)."""
    admitted, out = [], []
    for _ in range(300):
        admitted.append(eng.refill())
        if eng.n_active == 0:
            break
        out += eng.step(task)
    return admitted, out


@functools.lru_cache(maxsize=None)
def _jax_legacy(cache):
    """The JAX package's token-at-a-time engine over LENGTHS (prompts of
    seed 0, engine seed 1), run once and shared by the legacy and chunked
    admission tests."""
    jcfg, tcfg = _configs()
    jp, _ = _params(jcfg, tcfg)
    jprobs, _ = _prompts(LENGTHS)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(cache=cache, **LEGACY_EC),
                     _source(jprobs), seed=1)
    admitted, out = _legacy_loop(jeng, JTASK)
    return (jeng._paged, admitted, out, jeng.tokens_generated,
            jeng.allocator.live_pages if jeng._paged else 0)


@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_legacy_engine_matches_jax_legacy_loop(hyb, cache):
    """Token-at-a-time admission in both packages, slot cache and paged
    pool: the rows admitted by every refill and every rollout."""
    jcfg, tcfg, jp, tp = hyb
    _, tprobs = _prompts(LENGTHS)
    teng = GenerationEngine(tcfg, tp, EngineConfig(cache=cache, **LEGACY_EC),
                            _source(tprobs), seed=1, **CPU)
    jpaged, jadmitted, jout, jtokens, jlive = _jax_legacy(cache)
    assert teng._paged == (cache == "paged") == jpaged
    admitted, tout = _legacy_loop(teng, TASK)
    assert admitted == jadmitted
    _same(jout, tout)
    assert len(tout) == len(LENGTHS)
    assert teng.tokens_generated == jtokens
    if cache == "paged":
        assert teng.allocator.live_pages == jlive == 0


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_chunked_admission_matches_legacy(ring):
    """Chunked admission (4-token chunks) against the token-at-a-time loop
    of the port and of the JAX package, on a full cache and on a
    sliding-window ring (window 16 < max_len 32, prompts up to 22 tokens,
    so admission and decode wrap): same tokens, behavior logprobs within
    CHUNKED_ATOL."""
    kw = dict(attention_variant="sliding_window", sliding_window=16) \
        if ring else {}
    jcfg, tcfg = _configs(**kw)
    jp, tp = _params(jcfg, tcfg)
    # the full cache takes the legacy test's prompts and seeds, so the JAX
    # legacy run is the one that test made (`_jax_legacy`)
    lengths, pseed, seed = ([18, 9, 22, 13], 2, 3) if ring else \
        (LENGTHS, 0, 1)
    ec = dict(n_slots=3, max_len=32 if ring else 24, temperature=1e-6)
    outs = {}
    for chunk in (4, 0):
        _, probs = _prompts(lengths, seed=pseed)
        eng = GenerationEngine(tcfg, tp, EngineConfig(
            prefill_chunk=chunk, **ec), _source(probs), seed=seed, **CPU)
        assert eng._cache_len == (16 if ring else 24)
        outs[chunk] = _drain(eng, TASK)
    if ring:
        jprobs, _ = _prompts(lengths, seed=pseed)
        jeng = JaxEngine(jcfg, jp, JaxEngineConfig(prefill_chunk=0, **ec),
                         _source(jprobs), seed=seed)
        outs["jax"] = _drain(jeng, JTASK)
    else:
        outs["jax"] = _jax_legacy("slots")[2]
    assert len(outs[0]) == len(lengths)
    _same(outs[0], outs["jax"])
    _same(outs[4], outs[0], atol=CHUNKED_ATOL)
    _same(outs[4], outs["jax"], atol=CHUNKED_ATOL)


def _group_engines(tcfg, tp, prompts, **ec):
    kw = dict(n_slots=8, max_len=24, prefill_chunk=4, temperature=1e-6)
    kw.update(ec)
    slots = GenerationEngine(tcfg, tp, EngineConfig(**kw),
                             _source([Problem(list(p), 0) for p in prompts]),
                             seed=5, **CPU)
    paged = GenerationEngine(tcfg, tp, EngineConfig(
        cache="paged", page_size=8, **kw),
        _source([Problem(list(p), 0) for p in prompts]), seed=5, **CPU)
    return slots, paged


def test_prefix_sharing_forks_copy_the_leaders_ssm_rows(hyb):
    """Two GRPO groups of 4 identical prompts on a paged hybrid engine: one
    prefill per group, the forks take the leader's pages and a copy of its
    post-prefill conv and SSD rows, and every rollout equals the slot
    engine's bit for bit. Without the row copy a fork would start from
    zeroed SSM state."""
    jcfg, tcfg, jp, tp = hyb
    _, (a, b) = _prompts([7, 10], seed=8)
    prompts = [a.prompt_ids] * 4 + [b.prompt_ids] * 4
    slots, paged = _group_engines(tcfg, tp, prompts)
    assert slots.refill() == paged.refill() == 8
    assert paged.prompt_prefills == 2 and paged.prefix_forks == 6
    for k in ("conv", "ssd"):
        assert torch.equal(paged.state["cache"][k],
                           slots.state["cache"][k]), k
    _same(_drain(slots, TASK), _drain(paged, TASK), bitwise=True)
    assert paged.allocator.live_pages == 0 and paged.pages_copied > 0


def test_forks_without_the_row_copy_diverge(hyb, monkeypatch):
    """The check above fails when the fork copy of the SSM rows is taken
    out: a fork then decodes from zeroed conv and SSD rows."""
    jcfg, tcfg, jp, tp = hyb
    _, (a,) = _prompts([7], seed=8)
    slots, paged = _group_engines(tcfg, tp, [a.prompt_ids] * 4, n_slots=4)
    slots.refill()
    monkeypatch.setattr(paged, "_copy_fork_rows", lambda forks: None)
    paged.refill()
    assert paged.prefix_forks == 3
    for k in ("conv", "ssd"):
        assert not torch.equal(paged.state["cache"][k],
                               slots.state["cache"][k]), k
        assert not paged.state["cache"][k][:, 1:].any(), k
    out_s, out_p = _drain(slots, TASK), _drain(paged, TASK)
    lp_s = np.concatenate([r.behavior_logprobs for r in out_s])
    lp_p = np.concatenate([r.behavior_logprobs for r in out_p])
    assert lp_s.shape != lp_p.shape or not np.array_equal(lp_s, lp_p)


@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_recompute_kv_rewrites_attention_and_keeps_ssm_state(hyb, cache):
    """`recompute_kv` in the middle of decoding: the attention leaves take
    the new weights' K/V as the JAX engine's do, the conv and SSD rows stay
    as they were (neither package recomputes recurrent state), and the
    paged engine's pages equal the slot engine's gathered."""
    jcfg, tcfg, jp, tp = hyb
    jp2, tp2 = _params(jcfg, tcfg, seed=1)
    jprobs, tprobs = _prompts(LENGTHS[:3])
    ec = dict(n_slots=3, max_len=24, prefill_chunk=4, temperature=1e-6,
              cache=cache, page_size=8)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ec), _source(jprobs), seed=1)
    teng = GenerationEngine(tcfg, tp, EngineConfig(**ec), _source(tprobs),
                            seed=1, **CPU)
    jeng.refill(), teng.refill()
    for _ in range(3):
        jeng.step(JTASK), teng.step(TASK)
    before = {k: teng.state["cache"][k].clone() for k in ("conv", "ssd")}
    jeng.set_weights(jp2, 1, recompute_kv=True)
    teng.set_weights(tp2, 1, recompute_kv=True)
    for k in ("conv", "ssd"):
        assert torch.equal(teng.state["cache"][k], before[k]), k
    if cache == "paged":
        bt = torch.from_numpy(teng.tables.table).long()
        np.testing.assert_array_equal(teng.tables.table, jeng.tables.table)
        views = {k: teng.state["cache"][k][:, bt] for k in ("k", "v")}
        jviews = {k: np.asarray(jeng.state["cache"][k])[:, bt.numpy()]
                  for k in ("k", "v")}
    else:
        views = {k: teng.state["cache"][k] for k in ("k", "v")}
        jviews = {k: jeng.state["cache"][k] for k in ("k", "v")}
    nc = teng._host_ncached
    live = np.where(teng._host_active)[0]
    assert live.size >= 2
    for k in ("k", "v"):
        # a finished slot's row and positions past n_cached are dead
        for s in live:
            v = views[k][:, s].reshape((tcfg.n_layers, -1)
                                       + views[k].shape[-2:])
            jv = np.asarray(jviews[k])[:, s].reshape(v.shape)
            _close(v[:, :nc[s]], jv[:, :nc[s]], msg=k)
    _same(_drain(jeng, JTASK), _drain(teng, TASK))


# ---------------------------------------------------------------------------
# the Preprocessor, the Trainer and the loop
# ---------------------------------------------------------------------------

def _rollouts(n, seed=0, max_len=40):
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
    """Fused loss; the bucket (32) is a multiple of the SSM chunk, so every
    layer's SSM branch takes the scan kernel's path (its plain version
    here) against the Pallas kernel in interpret mode."""
    jcfg, tcfg = _configs(fused_loss=True)
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    jp, tp = _params(jcfg, tcfg)
    jr, tr = _rollouts(4, seed=2, max_len=30)
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
    """One step on a packed batch with the fused loss and remat. Metrics
    within 1e-5; params within 1e-6 but for at most 0.1% of a leaf's
    elements, and at most one element of the small norm leaves (an Adam
    step of lr 1e-3 on a gradient near zero turns a 1e-9 gradient
    difference into ~1e-6), all within 5e-5."""
    jcfg, tcfg = _configs(fused_loss=True, remat=True)
    jp, tp = _params(jcfg, tcfg)
    jtr = JaxTrainer(jcfg, jp, adam=JaxAdamConfig(lr=1e-3))
    ttr = Trainer(tcfg, tp, adam=AdamConfig(lr=1e-3), **CPU)
    batch = pack(_rollouts(6, seed=7)[1], batch=2, seq=64)
    jm = dict(jtr.step(dict(batch)))
    tm = dict(ttr.step(dict(batch)))
    assert set(jm) == set(tm) and ttr.version == jtr.version == 1
    assert "moe_aux" not in tm
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    for a, b in zip(tree_flatten(ttr.params)[0], jax.tree.leaves(jtr.params)):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert (np.abs(a - b) > 1e-6).sum() <= max(1, 1e-3 * a.size)
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)


def _trace(loop):
    fired, raw = [], loop.step

    def step():
        ok = raw()
        if ok:
            fired.append(loop.now)
        return ok

    loop.step = step
    return fired


def test_pipeline_matches_jax_pipeline():
    """3 optimizer steps of both packages' PipelineRL on paged engines
    (legacy admission, where the two packages agree to 1e-5), streamed
    broadcast: the same event schedule, versions, lags, token counts and
    rewards; losses within 1e-4 relative."""
    jtask, task = JaxTask(max_operand=3, ops="+"), MathTask(max_operand=3,
                                                           ops="+")
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    ec = dict(n_slots=8, max_len=16, temperature=1e-6, prefill_chunk=0,
              cache="paged", page_size=8)
    pc = dict(batch_size=8, n_opt_steps=3, n_chips=8, train_chips=4,
              pack_rows=3, pack_seq=64, broadcast="streamed",
              broadcast_chunks=4)
    J = JaxPipelineRL(jcfg, jp, jtask, JaxEngineConfig(**ec),
                      JaxPipelineConfig(**pc), trainer=JaxTrainer(jcfg, jp))
    T = PipelineRL(tcfg, tp, task, EngineConfig(**ec), PipelineConfig(**pc),
                   trainer=Trainer(tcfg, tp, **CPU), **CPU)
    fj, ft = _trace(J.loop), _trace(T.loop)
    jlog, tlog = J.run(), T.run()
    assert ft == fj
    assert len(tlog) == len(jlog) == 3
    for a, b in zip(jlog, tlog):
        for k in ("version", "samples", "time", "reward", "max_lag",
                  "mean_lag", "mean_len", "fill", "queue_depth"):
            assert b[k] == a[k], k
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
    je, te = J.engine, T.engine
    for k in ("version", "tokens_generated"):
        assert getattr(te, k) == getattr(je, k), k
    assert te._paged and te.version >= 1
