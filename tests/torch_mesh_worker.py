"""Four gloo ranks on the CPU for `tests/test_torch_mesh_runtime.py`.

    python tests/torch_mesh_worker.py INPUTS.pkl OUT_DIR

INPUTS.pkl holds the tiny config's parameter tree (numpy) drawn by the
test. The script spawns four ranks on one process group, each on one
torch thread, with a ("model",) mesh of all four, and runs the port's
real-mesh runtime: the mesh engine against the one-rank engine, the
executed weight stream with its integrity gate, the broadcaster's
executor, `engine_submeshes`, `PipelineRL(mesh=)` on two engines (slot and
paged caches), the co-sim trace and the placement of a whole tree. Each rank writes what it saw to
OUT_DIR/rank{r}.pt. It imports the port only.
"""
import os
import pickle
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
GREEDY = 1e-4


def _tasks():
    """Two identically seeded tasks: paired engines see the same prompts."""
    from repro_torch.data.math_task import MathTask
    return MathTask(max_operand=5, ops="+"), MathTask(max_operand=5, ops="+")


def _setup(inp):
    from repro_torch.configs import tiny
    from repro_torch.convert import params_from_numpy
    V = _tasks()[0].tok.vocab_size
    cfg = tiny.config(vocab_size=V, d_model=64, n_layers=1)
    return cfg, params_from_numpy(inp["tree"], cfg, device="cpu")


def _ec(**kw):
    from repro_torch import EngineConfig
    return EngineConfig(**dict(dict(n_slots=4, max_len=20,
                                    temperature=GREEDY), **kw))


def _plus(params, d):
    from repro_torch.core.weights import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [x + d for x in leaves])


def _whole(params):
    from repro_torch.core.weights import tree_flatten
    from repro_torch.shardctx import full
    return [full(x).clone() for x in tree_flatten(params)[0]]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _engine(cfg, params, mesh):
    """The mesh engine and the one-rank engine, 20 greedy steps each on the
    same prompts: per-step tokens and logprobs of both."""
    from repro_torch import GenerationEngine
    ta, tb = _tasks()
    ref = GenerationEngine(cfg, params, _ec(), ta.sample, seed=1,
                           device="cpu")
    eng = GenerationEngine(cfg, params, _ec(), tb.sample, seed=1,
                           device="cpu", mesh=mesh)
    out = {"ref_tokens": [], "ref_lp": [], "tokens": [], "lp": []}
    ref.refill()
    eng.refill()
    for _ in range(20):
        ref.step(ta)
        eng.step(tb)
        out["ref_tokens"].append(ref.state["tokens"].numpy().copy())
        out["ref_lp"].append(ref.state["lp"].numpy().copy())
        out["tokens"].append(eng.state["tokens"].numpy().copy())
        out["lp"].append(eng.state["lp"].numpy().copy())
        if ref.n_active == 0:
            ref.refill()
        if eng.n_active == 0:
            eng.refill()
    out["lockstep"] = dict(eng.lockstep)
    out["cache_placements"] = str(eng.state["cache"]["k"].placements)
    return out


def _stream(cfg, params, mesh):
    """A streamed install placed chunk by chunk on the mesh, one corrupt
    token rejected on the way, against an atomic `set_weights`."""
    from repro_torch import GenerationEngine
    from repro_torch.core.weights import (chunk_spans, chunk_token,
                                          span_bytes, stream_digest,
                                          tree_flatten)
    ta, tb = _tasks()
    eng = GenerationEngine(cfg, params, _ec(), tb.sample, seed=1,
                           device="cpu", mesh=mesh)
    ref = GenerationEngine(cfg, params, _ec(), ta.sample, seed=1,
                           device="cpu")
    params2 = _plus(params, 0.01)
    leaves = tree_flatten(params2)[0]
    sizes = span_bytes(leaves, chunk_spans(leaves, 4))
    good = [chunk_token(7, k, sizes[k]) for k in range(len(sizes))]
    eng.begin_weight_stream(params2, 7, n_chunks=4,
                            expect_digest=stream_digest(good))
    done, k, rejected_at_1 = False, 0, None
    while not done:
        tok = good[min(k, len(good) - 1)]
        if k == 1:
            rejected_at_1 = eng.stream_weight_chunk(token=tok ^ 0x5AD0BAD)
            rejected_at_1 = (rejected_at_1, eng.wchunks_rejected)
        done = eng.stream_weight_chunk(token=tok)
        k += 1
    ref.set_weights(params2, 7)
    chunk_recs = [r for r in eng.wexec_log if r["kind"] == "chunk"]
    return {"rejected_at_1": rejected_at_1,
            "installed": eng.last_stream_installed, "version": eng.version,
            "n_chunk_recs": len(chunk_recs),
            "chunk_seconds": [r["seconds"] for r in chunk_recs],
            "chunk_nbytes": [r["nbytes"] for r in chunk_recs],
            "bitwise": _equal(_whole(eng.params), _whole(ref.params))}


def _broadcaster(cfg, params, mesh):
    """`WeightBroadcaster(executor=MeshBroadcastExecutor())` onto a mesh
    engine; then the executor's same-mesh route from the train layout."""
    from repro_torch import GenerationEngine, HardwareModel, Trainer
    from repro_torch.core.events import (ActorStage, EventLoop,
                                         WeightBroadcaster)
    from repro_torch.launch.meshrt import MeshBroadcastExecutor
    _, tb = _tasks()
    eng = GenerationEngine(cfg, params, _ec(), tb.sample, seed=1,
                           device="cpu", mesh=mesh)
    params2 = _plus(params, 0.01)
    loop = EventLoop()
    stage = ActorStage(loop, eng, task=tb, name="a0")
    bc = WeightBroadcaster(HardwareModel(), [stage], mode="streamed",
                           n_chunks=4, executor=MeshBroadcastExecutor())
    bc.publish(params2, 3, now=0.0)
    stage.start(0.0)
    loop.run(until=lambda: stage.updates_applied >= 1)
    rec = bc.exec_records[0]
    out = {"version": eng.version, "n_records": len(bc.exec_records),
           "n_per_chunk": len(rec["per_chunk"]), "nbytes": rec["nbytes"],
           "executed": bc.stats()["executed"],
           "exec_seconds": bc.stats()["exec_seconds"],
           "bitwise": _equal(_whole(eng.params),
                             [x.clone() for x in _whole(params2)])}
    # publisher on the engine's own mesh: the trainer's layout
    # redistributed to the generation layout, chunk by chunk
    params3 = _plus(params, 0.02)
    tr = Trainer(cfg, params3, device="cpu", mesh=mesh)
    ex = MeshBroadcastExecutor()
    rec = ex.run(eng, tr.params, 4, 4)
    placed = [x for chunk in rec["chunks"] for x in chunk]
    out["same_mesh_jit"] = rec["jit"]
    out["same_mesh_bitwise"] = _equal([x.clone() for x in _whole(placed)],
                                      _whole(params3))
    out["same_mesh_placements"] = all(
        tuple(x.placements) == tuple(p)
        for x, p in zip(placed, eng._pshard_leaves))
    return out


def _submeshes(mesh):
    from repro_torch.launch.mesh import engine_submeshes
    subs = engine_submeshes(mesh, 2)
    out = {"ranks": [s.mesh.reshape(-1).tolist() for s in subs]}
    try:
        engine_submeshes(mesh, 3)
        out["three"] = "no error"
    except ValueError as e:
        out["three"] = f"ValueError: {e}"
    return out


def _pipeline(cfg, params, mesh, paged: bool):
    """PipelineRL on the mesh: two engines on disjoint 2-rank submeshes,
    the trainer on all four, a streamed broadcast in 4 chunks."""
    from repro_torch import PipelineConfig, PipelineRL
    from repro_torch.shardctx import STAGED
    ta, _ = _tasks()
    ec = _ec(cache="paged", page_size=4, paged_attention="kernel") \
        if paged else _ec()
    pc = PipelineConfig(batch_size=4, n_opt_steps=3, n_engines=2,
                        pack_rows=4, pack_seq=32, broadcast="streamed",
                        broadcast_chunks=4)
    gathers0 = dict(STAGED)
    pipe = PipelineRL(cfg, params, ta, ec, pc, mesh=mesh, device="cpu")
    fired, raw = [], pipe.loop.step

    def step():
        ok = raw()
        if ok:
            fired.append(pipe.loop.now)
        return ok

    pipe.loop.step = step
    rollouts, put = [], pipe.queue.put

    def put_and_record(rs):
        rollouts.extend(rs)
        put(rs)

    pipe.queue.put = put_and_record
    # the trainer's whole parameters at every version it reaches
    tr = pipe.trainer
    snaps, train_step = {0: _whole(tr.params)}, tr.step

    def step_and_snap(*a, **kw):
        m = train_step(*a, **kw)
        snaps[tr.version] = _whole(tr.params)
        return m

    tr.step = step_and_snap
    pipe.run()
    engines = []
    for e in pipe.engines:
        ep = _whole(e.params)
        engines.append({"version": e.version, "runs": e._runs,
                        "mesh_ranks": e.mesh.mesh.reshape(-1).tolist(),
                        # an engine holds the trainer's parameters of its
                        # version, bit for bit (checked on its own ranks)
                        "bitwise": (_equal(ep, snaps[e.version]) if e._runs
                                    else None),
                        "lockstep": dict(e.lockstep),
                        "wexec": len(e.wexec_log)})
    st = pipe.broadcast_stats()
    return {"log": pipe.log, "fired": fired,
            "stream": [np.asarray(r.tokens).tobytes()
                       + np.asarray(r.weight_versions).tobytes()
                       for r in rollouts],
            "trainer_version": pipe.trainer.version,
            "trainer_mesh": pipe.trainer.mesh is mesh,
            "devices": [a.devices for a in pipe.actors],
            "stats": {k: v for k, v in st.items()
                      if k not in ("exec_seconds", "engines")},
            "engine_stats": [{k: v for k, v in e.items()
                              if k not in ("pause_total",
                                           "pause_per_update")}
                             for e in st["engines"]],
            "engines": engines,
            "gathers": STAGED["gathers"] - gathers0["gathers"]}


def _restore(cfg, params, mesh, out_dir):
    """The mesh Trainer: a step, a checkpoint, two more steps; restored, the
    same two steps again give the same metrics bit for bit, and the
    restored state keeps the train layout."""
    from repro_torch import Trainer
    from repro_torch.data.packing import Rollout, pack
    rng = np.random.default_rng(5)
    rs = [Rollout(tokens=rng.integers(3, cfg.vocab_size, 12).astype(np.int32),
                  prompt_len=4,
                  behavior_logprobs=-rng.random(12).astype(np.float32),
                  reward=float(i % 2), weight_versions=np.zeros(12, np.int32))
          for i in range(4)]
    batch = pack(rs, 4, 16)
    tr = Trainer(cfg, params, device="cpu", mesh=mesh)
    placements = [tuple(x.placements) for x in
                  _leaves(tr.state)]
    tr.step(batch)
    path = tr.save(os.path.join(out_dir, "mesh_trainer"))
    first = [dict(tr.step(batch)) for _ in range(2)]
    v = tr.restore(path)
    again = [dict(tr.step(batch)) for _ in range(2)]
    return {"restored_version": v, "first": first, "again": again,
            "layout_kept": placements == [tuple(x.placements) for x in
                                          _leaves(tr.state)]}


def _leaves(tree):
    from repro_torch.core.weights import tree_flatten
    return tree_flatten(tree)[0]


def _lifetime(cfg, params, mesh):
    """A dropped mesh `PipelineRL` frees its tensors by reference counting
    (the garbage collector off): the trainer's parameters and moments,
    each engine's parameters and cache, their local shards."""
    import gc
    import weakref

    from repro_torch import PipelineConfig, PipelineRL
    from repro_torch.core.weights import tree_flatten
    from repro_torch.shardctx import is_distributed
    ta, _ = _tasks()
    pc = PipelineConfig(batch_size=4, n_opt_steps=2, n_engines=2,
                        pack_rows=4, pack_seq=32, broadcast="streamed",
                        broadcast_chunks=4)
    gc.collect()
    gc.disable()
    try:
        pipe = PipelineRL(cfg, params, ta, _ec(), pc, mesh=mesh,
                          device="cpu")
        pipe.run()
        executed = pipe.broadcast_stats()["executed"]
        held = [tree_flatten(pipe.trainer.state.params)[0][0],
                tree_flatten(pipe.trainer.state.opt.m)[0][0]]
        for eng in pipe.engines:
            held.append(tree_flatten(eng.params)[0][-1])
            if eng._runs:
                held.append(eng.state["cache"]["k"])
        held += [x.to_local() for x in held if is_distributed(x)]
        refs = [weakref.ref(t) for t in held]
        del pipe, eng, held
        return {"executed": executed, "n": len(refs),
                "alive": sum(r() is not None for r in refs)}
    finally:
        gc.enable()


def _placement(cfg, params, mesh):
    """Each rank hands the mesh engine and the mesh Trainer a different
    whole tree (the shared one plus the rank): the placed global
    parameters are the mesh's first rank's copy on every rank."""
    from repro_torch import GenerationEngine, Trainer
    task, _ = _tasks()
    mine = _plus(params, float(dist.get_rank()))
    eng = GenerationEngine(cfg, mine, _ec(), task.sample, seed=1,
                           device="cpu", mesh=mesh)
    tr = Trainer(cfg, mine, device="cpu", mesh=mesh)
    return {"engine": _equal(_whole(eng.params), _whole(params)),
            "trainer": _equal(_whole(tr.params), _whole(params))}


def _cosim(cfg, params, mesh):
    from repro_torch import GenerationEngine
    from repro_torch.launch.meshrt import record_cosim_trace, replay_trace
    task, _ = _tasks()
    eng = GenerationEngine(cfg, params, _ec(), task.sample, seed=2,
                           device="cpu", mesh=mesh)
    trace = record_cosim_trace(eng, _plus(params, 0.01), n_ticks=24,
                               publish_every=8, n_chunks=4, task=task)
    return {"trace": trace, "replay": replay_trace(trace)}


def _rank(rank, port, inputs, out_dir):
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        cfg, params = _setup(inp)
        mesh = DeviceMesh("cpu", torch.arange(WORLD),
                          mesh_dim_names=("model",))
        res = {"engine": _engine(cfg, params, mesh),
               "stream": _stream(cfg, params, mesh),
               "broadcaster": _broadcaster(cfg, params, mesh),
               "submeshes": _submeshes(mesh),
               "pipeline": {p: _pipeline(cfg, params, mesh, p)
                            for p in (False, True)},
               "cosim": _cosim(cfg, params, mesh),
               "placement": _placement(cfg, params, mesh),
               "lifetime": _lifetime(cfg, params, mesh),
               "restore": _restore(cfg, params, mesh, out_dir)}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    mp.spawn(_rank, args=(_free_port(), sys.argv[1], sys.argv[2]),
             nprocs=WORLD, join=True)
