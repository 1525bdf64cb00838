"""The JAX package's real-mesh runtime on four forced host devices, the
oracle of `tests/test_torch_mesh_runtime.py`.

    python tests/torch_mesh_jax_worker.py INPUTS.pkl OUT.pkl

XLA fixes its device count when JAX loads, so this runs in its own
process with `--xla_force_host_platform_device_count=4` set first. On a
("model",) mesh of the four devices it runs the mesh engine and the
one-device engine (20 greedy steps), `engine_submeshes`, one executed
broadcast, and `PipelineRL(mesh=)` with slot and paged engines, at the
sizes of the JAX package's `tests/test_mesh_runtime.py`, and pickles what
it saw. It imports the JAX package only.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.tiny import config as tiny_config  # noqa: E402
from repro.data.math_task import MathTask  # noqa: E402
from repro.sharding import DEFAULT_RULES  # noqa: E402

GREEDY = 1e-4
# every logical axis replicated on the mesh: under jax 0.9 the JAX
# package's mesh engine raises a ShardingTypeError as soon as one axis is
# split (the MLP's contraction, the GQA reshape, the embedding gather, the
# chunk's concatenation with a split cache), and its own mesh test fails
# the same way on 8 devices. The mesh code path (placement on the mesh and
# on disjoint submeshes, sharding_context, the executed broadcast) still
# runs. The port runs the default rules.
RULES = {k: None for k in DEFAULT_RULES}


def _tasks():
    return MathTask(max_operand=5, ops="+"), MathTask(max_operand=5, ops="+")


def _ec(**kw):
    from repro.core.rollout import EngineConfig
    return EngineConfig(**dict(dict(n_slots=4, max_len=20,
                                    temperature=GREEDY), **kw))


def _engine(cfg, params, mesh):
    from repro.core.rollout import GenerationEngine
    ta, tb = _tasks()
    ref = GenerationEngine(cfg, params, _ec(), ta.sample, seed=1)
    eng = GenerationEngine(cfg, params, _ec(), tb.sample, seed=1, mesh=mesh,
                           rules=RULES)
    out = {"ref_tokens": [], "ref_lp": [], "tokens": [], "lp": []}
    ref.refill()
    eng.refill()
    for _ in range(20):
        ref.step(ta)
        eng.step(tb)
        out["ref_tokens"].append(np.asarray(ref.state["tokens"]))
        out["ref_lp"].append(np.asarray(ref.state["lp"]))
        out["tokens"].append(np.asarray(eng.state["tokens"]))
        out["lp"].append(np.asarray(eng.state["lp"]))
        if ref.n_active == 0:
            ref.refill()
        if eng.n_active == 0:
            eng.refill()
    return out


def _broadcaster(cfg, params, mesh):
    from repro.core.events import ActorStage, EventLoop, WeightBroadcaster
    from repro.core.rollout import GenerationEngine
    from repro.core.sim import HardwareModel
    from repro.launch.meshrt import MeshBroadcastExecutor
    _, tb = _tasks()
    eng = GenerationEngine(cfg, params, _ec(), tb.sample, seed=1, mesh=mesh,
                           rules=RULES)
    params2 = jax.tree.map(lambda x: x + 0.01, params)
    loop = EventLoop()
    stage = ActorStage(loop, eng, task=tb, name="a0")
    bc = WeightBroadcaster(HardwareModel(), [stage], mode="streamed",
                           n_chunks=4, executor=MeshBroadcastExecutor())
    bc.publish(params2, 3, now=0.0)
    stage.start(0.0)
    loop.run(until=lambda: stage.updates_applied >= 1)
    rec = bc.exec_records[0]
    return {"version": eng.version, "n_per_chunk": len(rec["per_chunk"]),
            "nbytes": rec["nbytes"], "executed": bc.stats()["executed"]}


def _submeshes(mesh):
    from repro.launch.mesh import engine_submeshes
    subs = engine_submeshes(mesh, 2)
    out = {"sizes": [len(s.devices.reshape(-1)) for s in subs],
           "disjoint": not (set(subs[0].devices.reshape(-1))
                            & set(subs[1].devices.reshape(-1)))}
    try:
        engine_submeshes(mesh, 3)
        out["three"] = "no error"
    except ValueError as e:
        out["three"] = f"ValueError: {e}"
    return out


def _pipeline(cfg, params, mesh, paged: bool):
    from repro.core.pipeline import PipelineConfig, PipelineRL
    ta, _ = _tasks()
    ec = _ec(cache="paged", page_size=4) if paged else _ec()
    pc = PipelineConfig(batch_size=4, n_opt_steps=3, n_engines=2,
                        pack_rows=4, pack_seq=32, broadcast="streamed",
                        broadcast_chunks=4)
    pipe = PipelineRL(cfg, params, ta, ec, pc, mesh=mesh, rules=RULES)
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
    pipe.run()
    st = pipe.broadcast_stats()
    return {"log": [{k: (float(v) if isinstance(v, (np.floating, float))
                         else v) for k, v in r.items()} for r in pipe.log],
            "fired": fired,
            "stream": [np.asarray(r.tokens).tobytes()
                       + np.asarray(r.weight_versions).tobytes()
                       for r in rollouts],
            "trainer_version": pipe.trainer.version,
            "stats": {k: v for k, v in st.items()
                      if k not in ("exec_seconds", "engines")},
            "engine_stats": [{k: v for k, v in e.items()
                              if k not in ("pause_total",
                                           "pause_per_update")}
                             for e in st["engines"]]}


def main(inputs: str, out: str) -> None:
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    assert jax.device_count() == 4, jax.devices()
    V = _tasks()[0].tok.vocab_size
    cfg = tiny_config(vocab_size=V, d_model=64, n_layers=1)
    params = jax.tree.map(jnp.asarray, inp["tree"])
    mesh = jax.make_mesh((4,), ("model",))
    res = {"engine": _engine(cfg, params, mesh),
           "broadcaster": _broadcaster(cfg, params, mesh),
           "submeshes": _submeshes(mesh),
           "pipeline": {p: _pipeline(cfg, params, mesh, p)
                        for p in (False, True)}}
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
