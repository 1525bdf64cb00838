"""Shared builders for the twin tests of the port's Server, Evaluator,
fault plan and pool scheduling (`test_torch_serving.py`,
`test_torch_faults.py`, `test_torch_gray.py`,
`test_torch_scheduler_lag.py`, `test_torch_schedule_eval.py`).

Both packages start from the same converted weights (the tiny config, d
64, one layer, float32) and the same prompt streams. Each scenario runs
once per process (`functools.lru_cache`), so every test of a file that
reads it shares one JAX run and one port run.
"""
import atexit
import contextlib
import functools
import hashlib
import shutil
import tempfile
from typing import Callable, List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import HealthConfig as JaxHealthConfig
from repro.configs.tiny import config as jax_tiny
from repro.core import events as JE
from repro.core.algo import RLConfig as JaxRLConfig
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.core.pipeline import PipelineRL as JaxPipelineRL
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.core.sim import HardwareModel as JaxHardwareModel
from repro.core.trainer import Trainer as JaxTrainer
from repro.data.math_task import MathTask as JaxTask
from repro.models import model as JM
from repro.sharding import tree_values
from repro_torch import (EngineConfig, HardwareModel, PipelineConfig,
                         PipelineRL, RLConfig, Trainer)
from repro_torch.configs import tiny as port_tiny
from repro_torch.configs.base import HealthConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as TE
from repro_torch.core.weights import tree_flatten
from repro_torch.data.math_task import MathTask

CPU = {"device": "cpu"}
# slow interconnect + saturated decode (the JAX fault tests' scale): a
# 4-step run spans ~600 flashes, so fault windows land on live decode work
HW = dict(h_sat=16, bcast_bytes_per_flash=2e3, bcast_install_flash=1.0)
GREEDY = 1e-4


@functools.lru_cache(maxsize=None)
def weights(key: int = 0):
    """(jax cfg, port cfg, jax params, port params) of the tiny config."""
    V = MathTask(max_operand=5, ops="+").tok.vocab_size
    jcfg = jax_tiny(vocab_size=V, d_model=64, n_layers=1)
    tcfg = port_tiny.config(vocab_size=V, d_model=64, n_layers=1)
    tree = jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(key))))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, **CPU))


@contextlib.contextmanager
def one_thread():
    """Run torch on one CPU thread, then restore the count. The twins' tiny
    ops spend far longer in the intra-op thread pool than in arithmetic:
    the learning configuration of `test_torch_pipeline.py` took 70 s on 8
    threads and 2.4 s on one, on an idle 8-core CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def fake_dtensor(t: torch.Tensor):
    """`t` as a replicated DTensor on a one-rank fake process group, which
    is destroyed on exit (the group is process-global)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("model",))
        yield DTensor.from_local(t, mesh, [Replicate()], run_check=False)
    finally:
        dist.destroy_process_group()


def tasks(**kw):
    """A fresh task per package: the prompt stream's RNG is run state."""
    kw = dict(dict(max_operand=5, ops="+"), **kw)
    return JaxTask(**kw), MathTask(**kw)


def trace(loop) -> List[float]:
    """Record every event's firing time on `loop`."""
    fired, raw = [], loop.step

    def step():
        ok = raw()
        if ok:
            fired.append(loop.now)
        return ok

    loop.step = step
    return fired


def tap(p, record: list) -> None:
    """Record each rollout entering the SampleQueue."""
    put = p.queue.put

    def put_and_record(rollouts):
        record.extend(rollouts)
        put(rollouts)

    p.queue.put = put_and_record


def tempdir() -> str:
    d = tempfile.mkdtemp(prefix="twin_ckpt_")
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    return d


class Run(NamedTuple):
    p: object          # the PipelineRL
    fired: List[float]
    rollouts: list     # every rollout that entered the SampleQueue

    def stream(self) -> List[bytes]:
        """The rollouts' tokens and version stamps, as bytes."""
        return [np.asarray(r.tokens).tobytes()
                + np.asarray(r.weight_versions).tobytes()
                for r in self.rollouts]

    def digest(self) -> str:
        """sha256 over the recorded rollouts and the port's final
        parameters."""
        h = hashlib.sha256()
        for b in self.stream():
            h.update(b)
        for leaf in tree_flatten(self.p.trainer.params)[0]:
            h.update(leaf.numpy().tobytes())
        return h.hexdigest()


def pipe(port: bool, plan: Optional[Callable] = None, steps: int = 4,
         n_engines: int = 2, ckpt_every: int = 0, ckpt: bool = False,
         lag: bool = False, monitor: bool = True, guard: bool = True,
         interval: float = 20.0, speeds=None, ec: Optional[dict] = None,
         pc: Optional[dict] = None, seed: int = 0,
         task_kw: Optional[dict] = None, hw: bool = True) -> Run:
    """One PipelineRL of either package, run to `steps`, at the JAX fault
    tests' configuration: 2 engines of 8 slots, max_len 16, batch 4.
    `plan(module)` builds the FaultPlan from that package's `events`;
    `lag` arms the token_is objective and a max_lag of 2; `ec` and `pc`
    override the engine and pipeline fields."""
    jcfg, tcfg, jp, tp = weights()
    jtask, ttask = tasks(**(task_kw or {}))
    ec = dict(dict(n_slots=8, max_len=16, temperature=GREEDY), **(ec or {}))
    health = dict(enabled=monitor, interval=interval)
    pc = dict(dict(batch_size=4, n_opt_steps=steps, n_chips=8,
                   train_chips=4, pack_rows=2, pack_seq=48,
                   n_engines=n_engines, engine_speeds=speeds,
                   ckpt_every=ckpt_every, ckpt_dir=tempdir() if ckpt
                   else None, max_lag=2 if lag else None), **(pc or {}))
    if port:
        rl = RLConfig(lag_mode="token_is") if lag else RLConfig()
        p = PipelineRL(tcfg, tp, ttask, EngineConfig(**ec),
                       PipelineConfig(**pc, health=HealthConfig(**health)),
                       hw=HardwareModel(**HW) if hw else HardwareModel(),
                       trainer=Trainer(tcfg, tp, rl=rl, guard=guard, **CPU),
                       seed=seed, fault_plan=plan(TE) if plan else None,
                       **CPU)
    else:
        rl = JaxRLConfig(lag_mode="token_is") if lag else JaxRLConfig()
        p = JaxPipelineRL(
            jcfg, jp, jtask, JaxEngineConfig(**ec),
            JaxPipelineConfig(**pc, health=JaxHealthConfig(**health)),
            hw=JaxHardwareModel(**HW) if hw else JaxHardwareModel(),
            trainer=JaxTrainer(jcfg, jp, rl=rl, guard=guard),
            seed=seed, fault_plan=plan(JE) if plan else None)
    fired, record = trace(p.loop), []
    tap(p, record)
    p.run()
    return Run(p, fired, record)


def assert_same_run(j: Run, t: Run, rel: float = 1e-4) -> None:
    """The port's run equals the JAX package's: every event's firing time,
    the rollouts' tokens and stamps, the per-step log (losses within
    `rel`), the pool, trainer, broadcast and health counters and the fault
    log."""
    assert t.fired == j.fired
    assert t.stream() == j.stream()
    assert len(t.p.log) == len(j.p.log)
    for a, b in zip(j.p.log, t.p.log):
        for k in ("version", "samples", "time", "reward", "max_lag",
                  "mean_lag", "mean_len", "fill", "queue_depth", "stall",
                  "bad_step"):
            assert b[k] == a[k], k
        assert np.isfinite(b["loss"]) == np.isfinite(a["loss"])
        if np.isfinite(a["loss"]):
            assert abs(b["loss"] - a["loss"]) <= rel * abs(a["loss"]), \
                (a["loss"], b["loss"])
    assert t.p.pool_stats() == j.p.pool_stats()
    assert t.p.broadcast_stats() == j.p.broadcast_stats()
    assert t.p.lag_stats() == j.p.lag_stats()
    assert t.p.trainer.version == j.p.trainer.version


def torch_leaves(tree):
    return [x.detach().clone() for x in tree_flatten(tree)[0]]


def leaves_equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
