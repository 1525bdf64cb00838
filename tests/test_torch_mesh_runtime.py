"""The port's real-mesh runtime (`launch/meshrt.py`, the `mesh=` placement
of `GenerationEngine`, `Trainer` and `PipelineRL`) on four gloo ranks on
the CPU, held against the JAX package's: twins of the contracts of its
`tests/test_mesh_runtime.py` that concern the runtime, at its sizes (tiny,
d_model 64, one layer, 4 slots, max_len 20) and at greedy temperature.

One spawn of four ranks (`tests/torch_mesh_worker.py`, each rank on one
torch thread, a ("model",) mesh of all four, the default rules) and one
JAX subprocess on four forced host devices
(`tests/torch_mesh_jax_worker.py`) run every case; the two start together.
Under jax 0.9 the JAX package's mesh engine raises as soon as one logical
axis is split (its own mesh test fails so on 8 devices, ROADMAP.md C.14),
so the JAX side runs its mesh code path with every axis replicated, while
the port splits heads, vocab, MLP and the cache length. `replay_trace`
runs in this process in both packages.
"""
import functools
import os
import pickle
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs.tiny import config as jax_tiny
from repro.data.math_task import MathTask as JaxTask
from repro.launch.meshrt import replay_trace as jax_replay
from repro.models import model as JM
from repro.sharding import tree_values
from repro_torch.launch.meshrt import replay_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GREEDY = 1e-4


@functools.lru_cache(maxsize=None)
def _runs():
    """(every port rank's results, the JAX worker's results)."""
    V = JaxTask(max_operand=5, ops="+").tok.vocab_size
    cfg = jax_tiny(vocab_size=V, d_model=64, n_layers=1)
    tree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(cfg, jax.random.PRNGKey(0))))
    tmp = tempfile.mkdtemp(prefix="mesh_rt_")
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump({"tree": tree}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    jout = os.path.join(tmp, "jax.pkl")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", name), path, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, out in (("torch_mesh_worker.py", tmp),
                          ("torch_mesh_jax_worker.py", jout))]
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    with open(jout, "rb") as f:
        return ranks, pickle.load(f)


def _first_difference(a, b):
    """(step, slot, position) of the first token where two per-step token
    buffers differ, else None."""
    for i, (x, y) in enumerate(zip(a, b)):
        bad = np.argwhere(x != y)
        if len(bad):
            return (i,) + tuple(int(v) for v in bad[0])
    return None


def test_executed_stream_bitwise_with_integrity_gate():
    """Streamed install placed on the mesh chunk by chunk: a corrupt chunk
    token is rejected (no state change), the retransmit succeeds, and the
    final parameters equal an atomic `set_weights` of the same tree bit for
    bit. Every chunk leaves a measured transfer in `wexec_log`."""
    ranks, _ = _runs()
    for r in ranks:
        s = r["stream"]
        assert s["rejected_at_1"] == (False, 1)
        assert s["installed"] and s["version"] == 7
        assert s["n_chunk_recs"] == 4
        assert all(t > 0 for t in s["chunk_seconds"])
        assert s["bitwise"]
    assert len({tuple(r["stream"]["chunk_nbytes"]) for r in ranks}) == 1


def test_broadcaster_executor_records_real_transfers():
    """`WeightBroadcaster(executor=MeshBroadcastExecutor())`: a streamed
    publication executes per-chunk transfers onto the engine's mesh,
    records them as the JAX package does (same bytes, 4 chunks) and the
    installed tree is bitwise right; from the trainer's layout on the
    engine's own mesh the executor redistributes instead (`jit`)."""
    ranks, jr = _runs()
    jb = jr["broadcaster"]
    for r in ranks:
        b = r["broadcaster"]
        assert b["version"] == jb["version"] == 3
        assert b["n_records"] == b["executed"] == jb["executed"] == 1
        assert b["n_per_chunk"] == jb["n_per_chunk"] == 4
        assert b["nbytes"] == jb["nbytes"] > 0
        assert b["exec_seconds"] > 0
        assert b["bitwise"]
        assert b["same_mesh_jit"] is True
        assert b["same_mesh_bitwise"] and b["same_mesh_placements"]


def test_sharded_engine_decode_token_identical():
    """The mesh engine (heads, vocab, MLP and cache length split over four
    ranks) produces the tokens of the one-rank port engine, the JAX
    one-device engine and the JAX mesh engine step by step over 20 steps,
    logprobs within 1e-5; every rank sees the same. On a difference, the
    logit margin at the first differing token is printed."""
    ranks, jr = _runs()
    je = jr["engine"]
    for r in ranks:
        e = r["engine"]
        for name, other, lp in (("port one-rank", e["ref_tokens"],
                                 e["ref_lp"]),
                                ("jax one-device", je["ref_tokens"],
                                 je["ref_lp"]),
                                ("jax mesh", je["tokens"], je["lp"])):
            first = _first_difference(e["tokens"], other)
            if first is not None:
                i, s, t = first
                # at temperature T the chosen token's logprob is -margin/T
                print(f"{name}: first difference at step {i}, slot {s}, "
                      f"position {t}; logit margin "
                      f"{-e['lp'][i][s, t] * GREEDY:.3e} (mesh) / "
                      f"{-lp[i][s, t] * GREEDY:.3e} ({name})")
            assert first is None, name
            for a, b in zip(e["lp"], lp):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        assert e["cache_placements"] == "(Shard(dim=2),)"
        # one broadcast per step, one more per step with finished rows
        assert e["lockstep"]["broadcasts"] >= 20
    for r in ranks[1:]:
        for a, b in zip(r["engine"]["tokens"], ranks[0]["engine"]["tokens"]):
            np.testing.assert_array_equal(a, b)


def test_engine_submeshes_are_disjoint():
    ranks, jr = _runs()
    js = jr["submeshes"]
    assert js["sizes"] == [2, 2] and js["disjoint"]
    for r in ranks:
        s = r["submeshes"]
        assert s["ranks"] == [[0, 1], [2, 3]]
        # 4 ranks do not split 3 ways: both packages raise the same
        assert s["three"] == js["three"]
        assert s["three"].startswith("ValueError")


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_pipeline_on_mesh_end_to_end(paged):
    """The mesh trainer on all four ranks, two engines on disjoint 2-rank
    submeshes, the executed streamed broadcast: the trainer reaches version
    3, every engine holds the trainer's parameters of its version bit for
    bit, the actors own disjoint ranks, and the run equals the JAX mesh
    pipeline's event for event (firing times, rollouts and their stamps,
    the per-step log with losses within 1e-4, the broadcast counters).
    Every rank's log, rollouts and counters are equal (lockstep)."""
    ranks, jr = _runs()
    j = jr["pipeline"][paged]
    first = ranks[0]["pipeline"][paged]
    for rank, r in enumerate(ranks):
        p = r["pipeline"][paged]
        assert p["trainer_mesh"]
        assert p["trainer_version"] == j["trainer_version"] >= 3
        assert p["stats"]["executed"] >= 1
        assert p["stats"] == j["stats"]
        assert p["engine_stats"] == j["engine_stats"]
        a, b = p["devices"]
        assert a == (0, 1) and b == (2, 3) and not set(a) & set(b)
        for e in p["engines"]:
            assert e["runs"] == (rank in e["mesh_ranks"])
            if e["runs"]:
                assert e["bitwise"], e
        # event for event with the JAX mesh pipeline
        assert p["fired"] == j["fired"]
        assert p["stream"] == j["stream"]
        assert len(p["log"]) == len(j["log"])
        for x, y in zip(p["log"], j["log"]):
            for k in ("version", "samples", "time", "reward", "max_lag",
                      "mean_lag", "mean_len", "fill", "queue_depth",
                      "stall", "bad_step"):
                assert x[k] == y[k], k
            assert abs(x["loss"] - y["loss"]) <= 1e-4 * abs(y["loss"])
        # lockstep: every rank took the same decisions, bit for bit
        assert p["log"] == first["log"]
        assert p["fired"] == first["fired"]
        assert p["stream"] == first["stream"]
        assert [e["lockstep"] for e in p["engines"]] == \
            [e["lockstep"] for e in first["engines"]]


def test_cosim_replay_agrees_with_measurement():
    """A trace recorded on a mesh engine (decode steps, chunks placed on
    the mesh) replayed through the port's EventLoop twin reproduces the
    measured totals within the JAX test's 5%, with equal update counts and
    lag within 0.5."""
    ranks, _ = _runs()
    for r in ranks:
        rep = r["cosim"]["replay"]
        rel = (abs(rep["sim_total_s"] - rep["measured_total_s"])
               / max(rep["measured_total_s"], 1e-12))
        assert rel < 0.05, rel
        assert rep["updates_sim"] == rep["updates_measured"] == 2
        assert abs(rep["mean_lag_sim"] - rep["mean_lag_measured"]) <= 0.5
        assert rep["sim_pause_per_update"] > 0
        np.testing.assert_allclose(rep["sim_pause_per_update"],
                                   rep["measured_pause_per_update"],
                                   rtol=0.05)


def test_dropped_mesh_pipeline_frees_its_tensors():
    """With the garbage collector off, a dropped `PipelineRL(mesh=)` after
    executed publications frees the trainer's parameters and moments and
    each engine's parameters and cache, shards included: the executor
    holds its engines weakly (ROADMAP.md C.8's rule)."""
    for r in _runs()[0]:
        life = r["lifetime"]
        assert life["executed"] >= 1
        assert life["n"] >= 6 and life["alive"] == 0, life


def test_placement_takes_the_first_ranks_copy():
    """A whole tree placed on the mesh (the engine's parameters, the
    Trainer's state) is scattered from the mesh's first rank: ranks handed
    different trees all hold that rank's, never a mix of blocks."""
    for r in _runs()[0]:
        assert r["placement"] == {"engine": True, "trainer": True}


def test_mesh_trainer_restore_replays_its_steps():
    """`Trainer(mesh=)`: a checkpoint written from the first rank and
    restored re-placed in the train layout; the two steps after the
    restore repeat the two before it bit for bit, equal on every rank."""
    ranks = _runs()[0]
    for r in ranks:
        t = r["restore"]
        assert t["restored_version"] == 1 and t["layout_kept"]
        assert t["again"] == t["first"]
        assert t["first"] == ranks[0]["restore"]["first"]


def _synthetic_trace():
    """A fixed trace: 24 ticks, publications every 8 in 4 chunks, decode
    and chunk seconds drawn from a seed."""
    rng = np.random.default_rng(11)
    ticks, version, published, pending = [], 0, 0, 0
    for i in range(24):
        chunk_s = None
        if pending == 0 and i and i % 8 == 0:
            published += 1
            pending = 4
        if pending:
            chunk_s = float(rng.uniform(1e-4, 5e-4))
            pending -= 1
            if pending == 0:
                version = published
        ticks.append({"decode_s": float(rng.uniform(1e-3, 3e-3)),
                      "chunk_s": chunk_s, "version": version,
                      "published": published})
    return {"ticks": ticks, "n_chunks": 4, "publish_every": 8}


def test_replay_trace_matches_jax():
    """`replay_trace` is host logic on the EventLoop and ActorStage: on the
    same trace dict the port's result equals the JAX package's key for
    key."""
    trace = _synthetic_trace()
    assert replay_trace(trace) == jax_replay(trace)
    for r in _runs()[0][:1]:
        t = r["cosim"]["trace"]
        assert replay_trace(t) == jax_replay(t)
