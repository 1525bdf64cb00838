"""The port's paged KV cache against the JAX package's, on the CPU.

- The host half (`PageAllocator`, `BlockTables`): the hypothesis op
  sequences of `test_paged_cache.py` go through both packages' allocators,
  which must hold the same tables, refcounts and free lists after every op.
- The plain `flash_decode_paged` against the Pallas kernel in interpret mode
  (float32, atol 1e-5) with trash pages, shared pages and ragged lengths.
- The engine, twins of `test_paged_engine.py` for the GQA decoder (tiny
  config, 2 layers, d 64, float32): within the port the paged engine equals
  the slot engine bit for bit (tokens, behavior logprobs, version stamps);
  against the JAX paged engine at temperature 1e-4 (greedy) it gives the
  same tokens and stamps and the same page counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs.tiny import config as jax_tiny  # noqa: E402
from repro.core.events import PoolRouter as JaxRouter  # noqa: E402
from repro.core.rollout import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.core.rollout import GenerationEngine as JaxEngine  # noqa: E402
from repro.data.math_task import MathTask as JaxTask  # noqa: E402
from repro.data.math_task import Problem as JaxProblem  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_cache as jpc  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding import tree_values  # noqa: E402
from repro_torch.configs import tiny as port_tiny  # noqa: E402
from repro_torch.convert import (engine_state_from_numpy,  # noqa: E402
                                 engine_state_to_numpy, params_from_numpy)
from repro_torch.core.events import PoolRouter  # noqa: E402
from repro_torch.core.rollout import EngineConfig, GenerationEngine  # noqa: E402
from repro_torch.data.math_task import MathTask, Problem  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_cache as tpc  # noqa: E402

JTASK, TASK = JaxTask(max_operand=5, ops="+"), MathTask(max_operand=5, ops="+")
VOCAB = TASK.tok.vocab_size
EC = dict(n_slots=4, max_len=16, prefill_chunk=4, temperature=1e-4)
# page counters the JAX and the port paged engines must agree on
COUNTERS = ("prompt_prefills", "prefix_forks", "pages_copied",
            "slots_preempted", "prefill_invocations", "prefill_tokens",
            "tokens_generated")


# ---------------------------------------------------------------------------
# host half: the allocator and block tables under random op sequences
# ---------------------------------------------------------------------------

N_SLOTS, N_BLOCKS, PAGE_SIZE = 4, 4, 8


def _op_strategy():
    slot = st.integers(0, N_SLOTS - 1)
    return st.one_of(
        st.tuples(st.just("admit"), slot, st.integers(0, N_BLOCKS)),
        st.tuples(st.just("fork"), slot, slot),
        st.tuples(st.just("write"), slot, st.integers(0, N_BLOCKS - 1)),
        st.tuples(st.just("release"), slot, st.just(0)),
    )


def _apply(tables, op, out_of_pages):
    """One table mutation; returns what it returned, or "oop" when the pool
    ran out (a legal outcome, with the state left as it was)."""
    kind, a, b = op
    try:
        if kind == "admit":
            tables.release_row(a)
            return tables.alloc_prefix(a, b)
        if kind == "fork":
            if a == b:
                return None
            tables.release_row(a)
            return tables.fork_row(a, b)
        if kind == "write":
            return tables.ensure_writable(a, b)
        return (tables.release_row(a), tables.release_row(a))
    except out_of_pages:
        return "oop"


def _pair(n_pages):
    jt = jpc.BlockTables(N_SLOTS, N_BLOCKS, jpc.PageAllocator(n_pages,
                                                              PAGE_SIZE))
    tt = tpc.BlockTables(N_SLOTS, N_BLOCKS, tpc.PageAllocator(n_pages,
                                                              PAGE_SIZE))
    return jt, tt


def _same_host_state(jt, tt):
    np.testing.assert_array_equal(tt.table, jt.table)
    np.testing.assert_array_equal(tt.alloc.refcount, jt.alloc.refcount)
    assert tt.alloc._free == jt.alloc._free
    assert (tt.alloc.total_allocs, tt.alloc.cow_copies) == \
        (jt.alloc.total_allocs, jt.alloc.cow_copies)


@settings(max_examples=200, deadline=None)
@given(ops_=st.lists(_op_strategy(), max_size=60),
       n_pages=st.integers(2, 2 * N_SLOTS * N_BLOCKS))
def test_invariants_hold_under_random_interleavings(ops_, n_pages):
    """Twin of test_paged_cache.py: every op returns the same in both
    packages and leaves the same tables, refcounts and free lists; the
    port's cross-checks hold after every op."""
    jt, tt = _pair(n_pages)
    for op in ops_:
        assert _apply(tt, op, tpc.OutOfPages) == _apply(jt, op,
                                                        jpc.OutOfPages)
        tt.check()
        _same_host_state(jt, tt)
    for s in range(N_SLOTS):
        tt.release_row(s)
    assert tt.alloc.live_pages == 0 and tt.alloc.free_pages == n_pages - 1
    tt.check()


@settings(max_examples=100, deadline=None)
@given(ops_=st.lists(_op_strategy(), max_size=60),
       n_pages=st.integers(2, 2 * N_SLOTS * N_BLOCKS))
def test_determinism_given_op_sequence(ops_, n_pages):
    """Same ops on fresh allocators of both packages, twice: the same end
    state every time (page numbering is reproducible)."""
    states = []
    for _ in range(2):
        jt, tt = _pair(n_pages)
        for op in ops_:
            _apply(jt, op, jpc.OutOfPages)
            _apply(tt, op, tpc.OutOfPages)
        _same_host_state(jt, tt)
        states.append((tt.table.copy(), tt.alloc.refcount.copy(),
                       list(tt.alloc._free)))
    np.testing.assert_array_equal(states[0][0], states[1][0])
    np.testing.assert_array_equal(states[0][1], states[1][1])
    assert states[0][2] == states[1][2]


@settings(max_examples=100, deadline=None)
@given(st.data())
def test_double_free_always_raises(data):
    n_pages = data.draw(st.integers(3, 9))
    n = data.draw(st.integers(1, n_pages - 1))
    for mod in (jpc, tpc):
        alloc = mod.PageAllocator(n_pages, PAGE_SIZE)
        pages = [alloc.alloc() for _ in range(n)]
        victim = data.draw(st.sampled_from(pages))
        alloc.release(victim)
        with pytest.raises(ValueError, match="double free"):
            alloc.release(victim)
        with pytest.raises(ValueError):
            alloc.release(mod.TRASH_PAGE)


# ---------------------------------------------------------------------------
# the paged decode kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [4, 8])
def test_plain_flash_decode_paged_matches_pallas(page_size):
    """Shuffled pages, two rows sharing pages, unallocated blocks on a trash
    page full of large values, ragged lengths (page edges and not). The
    port's plain version also equals the plain flash_decode on the gathered
    view bit for bit."""
    rng = np.random.default_rng(page_size)
    B, H, KV, D, CL = 4, 8, 2, 16, 24
    NB = CL // page_size
    lengths = np.array([1, 9, CL, 13], np.int32)
    need = -(-lengths // page_size)
    n_pages = 1 + int(need.sum()) + 3
    free = list(rng.permutation(np.arange(1, n_pages)))
    bt = np.zeros((B, NB), np.int32)
    for b in range(B):
        for j in range(need[b]):
            bt[b, j] = free.pop()
    bt[3, :need[3] - 1] = bt[2, :need[3] - 1]          # rows 2, 3 share
    kp = rng.standard_normal((n_pages, page_size, KV, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page_size, KV, D)).astype(np.float32)
    kp[0] = vp[0] = 1e3                                # the trash page
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    exp = np.asarray(jops.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), scale=0.25, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    tbt, tlen = torch.from_numpy(bt), torch.from_numpy(lengths)
    out = ops.flash_decode_paged(tq, tk, tv, tbt, tlen, scale=0.25)
    np.testing.assert_allclose(out.numpy(), exp, atol=1e-5, rtol=0)
    view_k = tk[tbt.long()].flatten(1, 2)
    view_v = tv[tbt.long()].flatten(1, 2)
    assert torch.equal(out, ref.flash_decode_ref(tq, view_k, view_v, tlen,
                                                 scale=0.25))


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

def _configs(**kw):
    return (dataclasses.replace(jax_tiny(vocab_size=VOCAB, d_model=64), **kw),
            dataclasses.replace(port_tiny.config(vocab_size=VOCAB,
                                                 d_model=64), **kw))


def _params(jcfg, tcfg, seed=0):
    tree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(seed))))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


def _source(problems):
    it = iter(list(problems))
    return lambda: next(it, None)


def _ragged(lens=(3, 5, 9, 13)):
    return [list(range(2, 2 + n)) for n in lens]


class Trio:
    """The JAX paged engine, the port's slot engine and the port's paged
    engine on one prompt list, stepped in lockstep."""

    def __init__(self, jcfg, tcfg, jp, tp, prompts, seed, **ec):
        kw = dict(EC, **ec)
        paged = dict(kw, cache="paged", page_size=kw.pop("page_size", 4))
        kw.pop("paged_attention", None)
        self.jax = JaxEngine(jcfg, jp, JaxEngineConfig(**dict(
            paged, paged_attention="gather")),
            _source([JaxProblem(list(p), 0) for p in prompts]), seed=seed)
        self.slots = GenerationEngine(
            tcfg, tp, EngineConfig(**kw),
            _source([Problem(list(p), 0) for p in prompts]), seed=seed,
            device="cpu")
        self.paged = GenerationEngine(
            tcfg, tp, EngineConfig(**paged),
            _source([Problem(list(p), 0) for p in prompts]), seed=seed,
            device="cpu")
        self.out = {"jax": [], "slots": [], "paged": []}

    def engines(self):
        return (("jax", self.jax, JTASK), ("slots", self.slots, TASK),
                ("paged", self.paged, TASK))

    def refill(self):
        return [e.refill() for _, e, _ in self.engines()]

    def step(self):
        for name, e, task in self.engines():
            self.out[name].extend(e.step(task))

    def drain(self, updates=None, max_steps=300):
        updates = updates or {}
        for i in range(max_steps):
            if i in updates:
                for name, e, _ in self.engines():
                    updates[i](name, e)
            self.step()
            if all(e.n_active == 0 for _, e, _ in self.engines()):
                break

    def check(self, n):
        """paged == slots bit for bit; paged == JAX tokens, stamps and
        counters; every page returned."""
        by_slot = {k: sorted(v, key=lambda r: r.slot)
                   for k, v in self.out.items()}
        assert len(by_slot["jax"]) == len(by_slot["slots"]) \
            == len(by_slot["paged"]) == n
        for j, s, p in zip(by_slot["jax"], by_slot["slots"],
                           by_slot["paged"]):
            np.testing.assert_array_equal(p.tokens, s.tokens)
            np.testing.assert_array_equal(p.behavior_logprobs,
                                          s.behavior_logprobs)
            np.testing.assert_array_equal(p.weight_versions,
                                          s.weight_versions)
            assert p.prompt_len == s.prompt_len == j.prompt_len
            np.testing.assert_array_equal(p.tokens, j.tokens)
            np.testing.assert_array_equal(p.weight_versions,
                                          j.weight_versions)
        self.same_counters()
        for e in (self.jax, self.paged):
            assert e.allocator.live_pages == 0
            e.tables.check()

    def same_counters(self):
        for c in COUNTERS:
            assert getattr(self.paged, c) == getattr(self.jax, c), c
        assert self.paged.allocator.total_allocs == \
            self.jax.allocator.total_allocs
        assert self.paged.allocator._free == self.jax.allocator._free
        np.testing.assert_array_equal(self.paged.tables.table,
                                      self.jax.tables.table)


@pytest.fixture(scope="module")
def gqa():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jp2, tp2 = _params(jcfg, tcfg, seed=7)
    return jcfg, tcfg, jp, tp, jp2, tp2


def _set(new_j, new_t, **kw):
    def apply(name, e):
        e.set_weights(new_j if name == "jax" else new_t, 1, **kw)
    return apply


def test_paged_bitwise_equals_slots(gqa):
    """Ragged prompts and a mid-stream atomic update over live caches."""
    jcfg, tcfg, jp, tp, jp2, tp2 = gqa
    trio = Trio(jcfg, tcfg, jp, tp, _ragged(), seed=2)
    assert trio.refill() == [4, 4, 4]
    trio.drain({3: _set(jp2, tp2)})
    trio.check(4)


def test_paged_ring_cache_bitwise():
    """A sliding-window ring (window 8 < max_len 16): block j holds ring
    positions [j*PS, (j+1)*PS) and decode wraps through the same table."""
    jcfg, tcfg = _configs(attention_variant="sliding_window",
                          sliding_window=8)
    jp, tp = _params(jcfg, tcfg)
    trio = Trio(jcfg, tcfg, jp, tp, _ragged((4, 6, 11, 13)), seed=3)
    assert trio.paged.tables.n_blocks == 2
    assert trio.refill() == [4, 4, 4]
    trio.drain()
    trio.check(4)


def test_paged_streamed_update_bitwise(gqa):
    """The chunked weight stream interleaves with decode; version stamps
    stay exact on the paged engine."""
    jcfg, tcfg, jp, tp, jp2, tp2 = gqa
    trio = Trio(jcfg, tcfg, jp, tp, _ragged(), seed=6)
    trio.refill()
    for name, e, _ in trio.engines():
        e.begin_weight_stream(jp2 if name == "jax" else tp2, 1, n_chunks=4)

    def chunk(name, e):
        e.stream_weight_chunk()

    trio.drain({i: chunk for i in range(6)})
    trio.check(4)
    assert trio.paged.version == 1


@pytest.mark.parametrize("rec", [False, True], ids=["stale", "recompute"])
def test_paged_recompute_kv_bitwise(gqa, rec):
    """recompute_kv on pages: unshare every block, recompute the ring view,
    scatter it back through the table."""
    jcfg, tcfg, jp, tp, jp2, tp2 = gqa
    trio = Trio(jcfg, tcfg, jp, tp, _ragged(), seed=4)
    trio.refill()
    trio.drain({3: _set(jp2, tp2, recompute_kv=rec)})
    trio.check(4)


def test_prefix_sharing_prefills_once_and_stays_bitwise(gqa):
    """A 4-way group of one prompt: one prefill, three copy-on-write forks
    (P-1 = 5 splits a page of 4, so the forks copy at the divergence), the
    rollouts bit for bit the slot engine's."""
    jcfg, tcfg, jp, tp, _, _ = gqa
    G, pl = 4, 6
    trio = Trio(jcfg, tcfg, jp, tp, [list(range(3, 3 + pl))] * G, seed=5)
    assert trio.refill() == [G, G, G]
    assert trio.paged.prompt_prefills == 1
    assert trio.paged.prefix_forks == G - 1
    assert trio.paged.last_admit_prefill_tokens == pl - 1
    assert trio.slots.last_admit_prefill_tokens == G * (pl - 1)
    assert trio.paged.last_admit_pages == trio.jax.last_admit_pages
    trio.drain()
    trio.check(G)
    assert trio.paged.pages_copied >= G - 1


def test_prefix_sharing_off_prefills_everything(gqa):
    jcfg, tcfg, jp, tp, _, _ = gqa
    trio = Trio(jcfg, tcfg, jp, tp, [[3, 4, 5, 6, 7, 8]] * 4, seed=5,
                prefix_sharing=False)
    assert trio.refill() == [4, 4, 4]
    assert trio.paged.prompt_prefills == 4 and trio.paged.prefix_forks == 0
    trio.same_counters()


def test_paged_kernel_engine_matches_gather_engine(gqa):
    """paged_attention="kernel" reads the pool through the block table; in
    the port it equals the gather engine bit for bit (the JAX kernel's
    page-sized softmax blocks make it fp32-close only)."""
    jcfg, tcfg, jp, tp, _, _ = gqa
    ec = EngineConfig(**dict(EC, cache="paged", page_size=4))
    out = []
    for mode in ("gather", "kernel"):
        e = GenerationEngine(tcfg, tp,
                             dataclasses.replace(ec, paged_attention=mode),
                             _source([Problem(p, 0) for p in _ragged()]),
                             seed=2, device="cpu")
        assert e.refill() == 4
        done = []
        for _ in range(300):
            done += e.step(TASK)
            if e.n_active == 0:
                break
        out.append(sorted(done, key=lambda r: r.slot))
        assert e.allocator.live_pages == 0
    assert len(out[0]) == len(out[1]) == 4
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.behavior_logprobs,
                                      b.behavior_logprobs)


def test_can_admit_and_page_costing(gqa):
    """Two distinct 13-token prompts, 5 usable pages: the first takes 4
    blocks, the second is deferred; slot engines cost 0 pages."""
    jcfg, tcfg, jp, tp, _, _ = gqa
    prompts = [list(range(2, 15)), list(range(3, 16))]
    trio = Trio(jcfg, tcfg, jp, tp, prompts, seed=1, n_slots=2, n_pages=6)
    e = trio.paged
    assert e.pages_needed(13) == trio.jax.pages_needed(13) == 4
    assert e.can_admit(13)
    assert trio.refill() == [1, 2, 1]
    assert len(e._deferred) == len(trio.jax._deferred) == 1
    assert not e.can_admit(13) and not trio.jax.can_admit(13)
    assert e.last_admit_pages == trio.jax.last_admit_pages >= 3
    assert trio.slots.pages_needed(13) == 0
    trio.same_counters()


def test_eviction_under_page_pressure_loses_nothing(gqa):
    """A pool far too small for the slot count: admission defers, decode
    preempts the least-progressed slot, and every prompt completes once,
    with the same preemptions as the JAX engine and no leaked page."""
    jcfg, tcfg, jp, tp, _, _ = gqa
    prompts = [JTASK.sample().prompt_ids for _ in range(8)]
    ec = dict(EC, cache="paged", page_size=4, n_pages=7)
    ej = JaxEngine(jcfg, jp, JaxEngineConfig(**ec),
                   _source([JaxProblem(p, 0) for p in prompts]), seed=5)
    et = GenerationEngine(tcfg, tp, EngineConfig(**ec),
                          _source([Problem(p, 0) for p in prompts]), seed=5,
                          device="cpu")
    done = {"j": [], "t": []}
    for _ in range(400):
        assert ej.refill() == et.refill()
        done["j"] += ej.step(JTASK)
        done["t"] += et.step(TASK)
        assert ej.n_active == et.n_active
        if et.n_active == 0 and not et._deferred:
            break
    assert len(done["t"]) == len(done["j"]) == 8
    assert et.slots_preempted == ej.slots_preempted > 0
    for a, b in zip(done["j"], done["t"]):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert et.allocator.live_pages == 0
    et.tables.check()


def test_reset_slots_releases_shared_pages(gqa):
    """An engine kill mid-group: every page reference returns to the pool
    (shared prefix pages once per holding fork), the deferred queue is
    salvageable first, and the device table is all trash page."""
    jcfg, tcfg, jp, tp, _, _ = gqa
    group = [Problem([3, 4, 5, 6, 7, 8], 0) for _ in range(4)]
    ec = EngineConfig(**dict(EC, n_slots=2, cache="paged", page_size=4))
    e = GenerationEngine(tcfg, tp, ec, _source(group), seed=1, device="cpu")
    assert e.refill() == 2
    e.step(TASK)
    e._deferred.append(Problem([9, 9], 0))
    assert e.allocator.live_pages > 0
    assert [p.prompt_ids for p in e.drain_deferred()] == [[9, 9]]
    assert e.reset_slots() == 2
    assert e.allocator.live_pages == 0
    e.tables.check()
    assert int(e._bt.sum()) == 0


def test_router_declines_pull_when_pages_short(gqa):
    jcfg, tcfg, jp, tp, _, _ = gqa
    prompts = [list(range(2, 15)), list(range(3, 16))]
    ec = dict(EC, n_slots=2, cache="paged", page_size=4, n_pages=6)
    results = []
    for router_cls, eng_cls, ec_cls, prob, kw in (
            (JaxRouter, JaxEngine, JaxEngineConfig, JaxProblem, {}),
            (PoolRouter, GenerationEngine, EngineConfig, Problem,
             {"device": "cpu"})):
        router = router_cls(_source([prob(p, 0) for p in prompts]))
        params = jp if eng_cls is JaxEngine else tp
        e = eng_cls(jcfg if eng_cls is JaxEngine else tcfg, params,
                    ec_cls(**ec), None, seed=1, **kw)
        i = router.add_engine(e)
        e.prompt_source = router.source_for(i)
        results.append((e.refill(), e.refill(), router.declined[i] >= 1,
                        len(router.pending), len(e._deferred)))
    assert results[0] == results[1] == (1, 0, True, 1, 0)


def test_engines_continue_from_one_converted_paged_state(gqa):
    """The converter carries the JAX engine's paged state (pools, block
    table, refcounts, free list, token buffer, counters) into the port's
    engine mid-group; both then decode the same tokens and end with the
    same pages."""
    jcfg, tcfg, jp, tp, _, _ = gqa
    prompt = [3, 4, 5, 6, 7, 8]
    ec = dict(EC, cache="paged", page_size=4)
    ej = JaxEngine(jcfg, jp, JaxEngineConfig(**ec),
                   _source([JaxProblem(prompt, 0)] * 4), seed=5)
    et = GenerationEngine(tcfg, tp, EngineConfig(**ec), _source([]),
                          seed=5, device="cpu")
    ej.refill()
    for _ in range(3):
        ej.step(JTASK)
    copied0 = ej.pages_copied
    state = {"state": {k: np.asarray(ej.state[k]) for k in
                       ("tokens", "lp", "n_cached", "prompt_len", "active")},
             "host": {k: np.array(getattr(ej, k)) for k in
                      ("_host_active", "_host_ncached", "_host_prompt_len",
                       "ver_buf")},
             "table": ej.tables.table, "refcount": ej.allocator.refcount,
             "free": ej.allocator._free}
    state["state"]["cache"] = {k: np.asarray(v)
                               for k, v in ej.state["cache"].items()}
    engine_state_from_numpy(et, state)
    et.problems = [Problem(prompt, 0) for _ in range(4)]
    back = engine_state_to_numpy(et)
    np.testing.assert_array_equal(back["state"]["cache"]["k"],
                                  state["state"]["cache"]["k"])
    assert back["free"] == list(ej.allocator._free)
    out_j, out_t = [], []
    for _ in range(40):
        out_j += ej.step(JTASK)
        out_t += et.step(TASK)
        if ej.n_active == 0 and et.n_active == 0:
            break
    assert len(out_j) == len(out_t) == 4
    for a, b in zip(sorted(out_j, key=lambda r: r.slot),
                    sorted(out_t, key=lambda r: r.slot)):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert et.pages_copied == ej.pages_copied - copied0
    assert et.allocator._free == ej.allocator._free
    assert et.allocator.live_pages == 0
