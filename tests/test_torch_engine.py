"""The port's `GenerationEngine` against the JAX package's, on the CPU, at
the tiny dense config (2 layers, d 64).

Both engines get the same converted weights and the same prompt list. At
temperature 1e-6 sampling is greedy, so the two must produce identical
tokens, version stamps and prompt lengths (their random draws differ: the
port samples by Gumbel-max on a torch.Generator). Caches and logits are
compared within atol 1e-5 in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import config as jax_tiny
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.core.rollout import GenerationEngine as JaxEngine
from repro.data.math_task import MathTask as JaxTask
from repro.data.math_task import Problem as JaxProblem
from repro.models import model as JM
from repro.sharding import tree_values
from repro_torch.configs import tiny as port_tiny
from repro_torch.convert import params_from_numpy
from repro_torch.core import weights as W
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.data.math_task import MathTask, Problem
from repro_torch.models import model as TM

JTASK, TASK = JaxTask(max_operand=5, ops="+"), MathTask(max_operand=5, ops="+")
VOCAB = TASK.tok.vocab_size
ATOL = 1e-5


def _configs(**kw):
    return (dataclasses.replace(jax_tiny(vocab_size=VOCAB, d_model=64), **kw),
            dataclasses.replace(port_tiny.config(vocab_size=VOCAB, d_model=64),
                                **kw))


def _params(jcfg, tcfg, seed=0):
    tree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(seed))))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


def _prompts(lengths, seed=0):
    """Random prompts of the given lengths, as each package's Problem."""
    rng = np.random.default_rng(seed)
    ids = [[1] + rng.integers(3, VOCAB, n - 1).tolist() for n in lengths]
    return ([JaxProblem(list(p), 0) for p in ids],
            [Problem(list(p), 0) for p in ids])


def _source(problems):
    it = iter(list(problems))
    return lambda: next(it, None)


def _engines(jcfg, tcfg, jp, tp, problems, seed=0, **ec):
    jprobs, tprobs = problems
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ec), _source(jprobs),
                     seed=seed)
    teng = GenerationEngine(tcfg, tp, EngineConfig(**ec), _source(tprobs),
                            seed=seed, device="cpu")
    return jeng, teng


def _valid_slots(nc: int, CL: int) -> np.ndarray:
    """Cache slots holding a position < nc (ring addressing when nc > CL)."""
    j = np.arange(CL)
    p = (nc - 1) - np.mod(nc - 1 - j, CL)
    return p >= 0


def _assert_caches_close(jeng, teng, atol=ATOL):
    for k in ("k", "v"):
        a = np.asarray(jeng.state["cache"][k], np.float32)
        b = teng.state["cache"][k].float().numpy()
        assert a.shape == b.shape
        for s in range(a.shape[1]):
            ok = _valid_slots(int(teng._host_ncached[s]), a.shape[2])
            np.testing.assert_allclose(b[:, s, ok], a[:, s, ok], atol=atol,
                                       rtol=0, err_msg=f"{k}[{s}]")


def _run(jeng, teng, updates=None, max_steps=400):
    """Refill and step both engines until both have drained; `updates` maps
    a step to a callable applied to both engines before it. Returns the
    finished rollouts of each, in finishing order."""
    updates = updates or {}
    jout, tout = [], []
    for step in range(max_steps):
        if step in updates:
            updates[step](jeng, teng)
        assert jeng.refill() == teng.refill()
        assert jeng.oldest_inflight_version() == teng.oldest_inflight_version()
        jout += jeng.step(JTASK)
        tout += teng.step(TASK)
        assert jeng.n_active == teng.n_active
        if jeng.n_active == 0 and teng.n_active == 0:
            break
    return jout, tout


def _assert_same_rollouts(jout, tout):
    assert len(jout) == len(tout) > 0
    for a, b in zip(jout, tout):
        assert a.slot == b.slot and a.prompt_len == b.prompt_len
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.weight_versions, a.weight_versions)
        assert b.truncated == a.truncated and b.reward == a.reward


# ---------------------------------------------------------------------------

def test_refill_matches_jax():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jeng, teng = _engines(jcfg, tcfg, jp, tp, _prompts([9, 33, 17, 40]),
                          n_slots=4, max_len=64, prefill_chunk=16)
    assert jeng.refill() == teng.refill() == 4
    assert teng.prefill_invocations == jeng.prefill_invocations == 3
    assert teng.prefill_tokens == jeng.prefill_tokens
    np.testing.assert_array_equal(teng._host_ncached, jeng._host_ncached)
    np.testing.assert_array_equal(teng.state["n_cached"].numpy(),
                                  np.asarray(jeng.state["n_cached"]))
    _assert_caches_close(jeng, teng)
    # the sampling distribution of the next step (temperature 1): logits of
    # a decode step on each engine's state
    idx = np.arange(4)
    nc = teng._host_ncached
    tst = teng.state
    tcache = {k: v.clone() for k, v in tst["cache"].items()}
    tl = TM.decode_step(tp, tst["tokens"][idx, nc][:, None],
                        torch.from_numpy(nc)[:, None], tcache,
                        torch.from_numpy(nc), tcfg, ring=False)["logits"]
    jst = jeng.state
    jl = JM.decode_step(jp, jst["tokens"][idx, nc][:, None],
                        jnp.asarray(nc)[:, None], jst["cache"],
                        jnp.asarray(nc), jcfg, ring=False)["logits"]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_drain_with_inflight_updates_matches_jax():
    """Identical tokens, per-token weight versions and prompt lengths across
    an atomic update, an update streamed in 4 chunks (checksummed, with the
    same span sizes as the JAX engine's) and a recompute_kv update."""
    jcfg, tcfg = _configs()
    versions = [_params(jcfg, tcfg, seed) for seed in range(4)]
    jeng, teng = _engines(jcfg, tcfg, *versions[0],
                          ([JTASK.sample() for _ in range(7)],
                           [TASK.sample() for _ in range(7)]),
                          n_slots=3, max_len=32, prefill_chunk=8,
                          temperature=1e-6)
    stream = {}

    def atomic(je, te):
        je.set_weights(versions[1][0], 1)
        te.set_weights(versions[1][1], 1)

    def begin(je, te):
        js = je.begin_weight_stream(versions[2][0], 2, n_chunks=4)
        ts = te.begin_weight_stream(versions[2][1], 2, n_chunks=4)
        assert ts == js and len(ts) == 4
        stream["tokens"] = [W.chunk_token(2, k, n) for k, n in enumerate(ts)]
        stream["k"] = 0

    def chunk(je, te):
        tok = stream["tokens"][stream["k"]]
        assert je.stream_weight_chunk(tok) == te.stream_weight_chunk(tok)
        assert te.version == je.version
        stream["k"] += 1

    def recompute(je, te):
        je.set_weights(versions[3][0], 3, recompute_kv=True)
        te.set_weights(versions[3][1], 3, recompute_kv=True)
        _assert_caches_close(je, te)

    updates = {4: atomic, 8: lambda je, te: (begin(je, te), chunk(je, te)),
               9: chunk, 10: chunk, 11: chunk, 16: recompute}
    jout, tout = _run(jeng, teng, updates)
    _assert_same_rollouts(jout, tout)
    assert teng.version == 3 and teng.wstreams_torn == 0
    stamps = set(np.concatenate([r.weight_versions[r.prompt_len:]
                                 for r in tout]).tolist())
    assert stamps == {0, 1, 2, 3}
    for r in tout:
        assert (r.weight_versions[:r.prompt_len] == 0).all()
        assert (np.diff(r.weight_versions) >= 0).all()
        assert np.isfinite(r.behavior_logprobs).all()


def test_stream_integrity_gate():
    """A chunk with a bad checksum is rejected without advancing; a stream
    whose digest does not match never installs."""
    _, tcfg = _configs()
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    new = TM.init_params(tcfg, seed=1, device="cpu")
    eng = GenerationEngine(tcfg, tp, EngineConfig(n_slots=2, max_len=16),
                           lambda: None, device="cpu")
    sizes = eng.begin_weight_stream(new, 1, n_chunks=2, expect_digest=12345)
    assert not eng.stream_weight_chunk(token=0)
    assert eng.wchunks_rejected == 1 and eng.stream_active
    for k in range(2):
        eng.stream_weight_chunk(token=W.chunk_token(1, k, sizes[k]))
    assert eng.wstreams_torn == 1 and not eng.last_stream_installed
    assert eng.version == 0 and eng.params is tp


def test_chunked_admission_equals_legacy_loop():
    """Inside the port: chunked prefill lands the engine in the state the
    token-at-a-time loop (prefill_chunk=0) reaches, bitwise on the first
    layer's K/V (a projection of the same embedding) and within 1e-5 on
    the later layers (whose inputs went through attention kernels that sum
    in another order); then identical greedy completions."""
    _, tcfg = _configs()
    tp = params_from_numpy(jax.tree.map(np.asarray, tree_values(
        JM.init_params(_configs()[0], jax.random.PRNGKey(0)))), tcfg, "cpu")
    probs = _prompts([23] * 4, seed=1)[1]   # one length: one forcing loop
    common = dict(n_slots=4, max_len=48, temperature=1e-6)
    a = GenerationEngine(tcfg, tp, EngineConfig(prefill_chunk=8, **common),
                         _source(probs), device="cpu")
    b = GenerationEngine(tcfg, tp, EngineConfig(prefill_chunk=0, **common),
                         _source(probs), device="cpu")
    assert a.refill() == b.refill() == 4
    for _ in range(int(a._host_prompt_len.max()) - 1):
        b.step(TASK)
    np.testing.assert_array_equal(a._host_ncached, b._host_ncached)
    np.testing.assert_array_equal(a.state["n_cached"].numpy(),
                                  b.state["n_cached"].numpy())
    for k in ("k", "v"):
        for s in range(4):
            n = int(a._host_ncached[s])
            ca, cb = a.state["cache"][k][:, s, :n], b.state["cache"][k][:, s, :n]
            torch.testing.assert_close(ca[0], cb[0], rtol=0, atol=0)
            torch.testing.assert_close(ca, cb, rtol=0, atol=ATOL)
    outa = sorted(_run_one(a), key=lambda r: r.slot)
    outb = sorted(_run_one(b), key=lambda r: r.slot)
    assert len(outa) == len(outb) == 4
    for ra, rb in zip(outa, outb):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        np.testing.assert_allclose(ra.behavior_logprobs, rb.behavior_logprobs,
                                   atol=ATOL)


def _run_one(eng, max_steps=200):
    out = []
    for _ in range(max_steps):
        out += eng.step(TASK)
        if eng.n_active == 0:
            break
    return out


def test_sliding_window_ring_matches_jax():
    """A ring cache (window 16 < max_len 32) with prompts longer than the
    window, and a recompute_kv update that rebuilds the ring in place."""
    jcfg, tcfg = _configs(attention_variant="sliding_window",
                          sliding_window=16)
    jp, tp = _params(jcfg, tcfg)
    jp2, tp2 = _params(jcfg, tcfg, seed=1)
    jeng, teng = _engines(jcfg, tcfg, jp, tp,
                          _prompts([20, 27, 9, 18, 23], seed=2), n_slots=3,
                          max_len=32, prefill_chunk=8, temperature=1e-6)
    assert jeng.refill() == teng.refill() == 3
    assert teng.state["cache"]["k"].shape[2] == 16
    _assert_caches_close(jeng, teng)

    def recompute(je, te):
        je.set_weights(jp2, 1, recompute_kv=True)
        te.set_weights(tp2, 1, recompute_kv=True)
        _assert_caches_close(je, te)

    jout, tout = _run(jeng, teng, {5: recompute})
    _assert_same_rollouts(jout, tout)


@pytest.mark.parametrize("policy", ["reject", "truncate"])
def test_long_prompts_match_jax(policy):
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jeng, teng = _engines(jcfg, tcfg, jp, tp,
                          _prompts([5, 40, 6, 31, 30, 7], seed=3), n_slots=2,
                          max_len=32, prefill_chunk=8, temperature=1e-6,
                          long_prompt=policy)
    rejected = []
    teng.on_prompt_rejected = rejected.append
    jout, tout = _run(jeng, teng)
    _assert_same_rollouts(jout, tout)
    assert teng.prompts_rejected == jeng.prompts_rejected
    assert teng.prompts_truncated == jeng.prompts_truncated
    if policy == "reject":
        assert teng.prompts_rejected == 2 and len(tout) == 4
        assert [len(p.prompt_ids) for p in rejected] == [40, 31]
    else:
        assert teng.prompts_truncated == 2 and len(tout) == 6
        assert sorted(r.prompt_len for r in tout)[-2:] == [30, 30]


def test_reset_slots_matches_jax():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jeng, teng = _engines(jcfg, tcfg, jp, tp,
                          _prompts([6, 12, 8, 10, 7], seed=4), n_slots=3,
                          max_len=24, prefill_chunk=4, temperature=1e-6)
    assert jeng.refill() == teng.refill() == 3
    for _ in range(3):
        jeng.step(JTASK)
        teng.step(TASK)
    teng.begin_weight_stream(tp, 1, n_chunks=2)
    assert teng.reset_slots() == jeng.reset_slots() == 3
    assert teng.n_active == 0 and not teng.stream_active
    assert not teng.state["active"].any()
    assert (teng.state["n_cached"] == 0).all()
    jout, tout = _run(jeng, teng)
    _assert_same_rollouts(jout, tout)
    assert len(tout) == 2


def test_engine_config_rejects_unknown_cache_and_read_path():
    """The paged cache is ported (tests/test_torch_paged.py); a cache or a
    paged read path the engine does not know still raises."""
    _, tcfg = _configs()
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="cache"):
        GenerationEngine(tcfg, tp, EngineConfig(cache="ring"), lambda: None,
                         device="cpu")
    with pytest.raises(ValueError, match="paged_attention"):
        GenerationEngine(tcfg, tp, EngineConfig(cache="paged",
                                                paged_attention="pallas"),
                         lambda: None, device="cpu")
    eng = GenerationEngine(tcfg, tp, EngineConfig(cache="paged"),
                           lambda: None, device="cpu")
    assert eng.free_pages == eng.allocator.n_pages - 1
