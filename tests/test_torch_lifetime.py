"""A dropped `PipelineRL` (or `ConventionalRL`, or `Server`) frees its
device memory by reference counting: with the cyclic garbage collector
disabled, its trainer's parameter tensors, Adam moments and engine caches
die on `del` — with a fault plan's events pending too.

Ownership runs one way (`repro_torch/core/events.py`): the orchestrator
holds the loop, the loop's heap the stages, the stages the engines and the
trainer; stages see the loop through a weak proxy and call back into their
owner through `weak_method`. A cycle anywhere on that path would keep the
tensors alive until `gc.collect()`, which is what these tests rule out;
so would the cycle that torch's first import of torch._dynamo leaves on
the stack of a rematerialised step (`models/model.py` imports it first).
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

from repro_torch import (ConventionalConfig, ConventionalRL, EngineConfig,
                         FaultPlan, PipelineConfig, PipelineRL, Server,
                         Trainer)
from repro_torch.configs import tiny as port_tiny
from repro_torch.core.events import EventLoop, weak_method
from repro_torch.core.weights import tree_flatten
from repro_torch.data.math_task import MathTask
from repro_torch.data.packing import Rollout, pack
from repro_torch.models import model as M

CPU = {"device": "cpu"}
PC = dict(batch_size=4, n_chips=8, train_chips=4, pack_rows=2, pack_seq=48)


@pytest.fixture(scope="module")
def setup():
    task = MathTask(max_operand=5, ops="+")
    cfg = port_tiny.config(vocab_size=task.tok.vocab_size, d_model=64,
                           n_layers=1)
    return task, cfg, M.init_params(cfg, 0, **CPU)


@pytest.fixture
def no_gc():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _tensors(trainer, engine, params):
    """Weak references to one parameter tensor of the trainer (a new one,
    made by the optimizer), one Adam moment and one engine cache tensor."""
    param = tree_flatten(trainer.state.params)[0][0]
    assert all(param is not p for p in tree_flatten(params)[0])
    moment = tree_flatten(trainer.state.opt.m)[0][0]
    cache = tree_flatten(engine.state["cache"])[0][0]
    return [weakref.ref(t) for t in (param, moment, cache)]


def _faults():
    """Every kind the pipeline schedules as an event, some still pending
    when the run stops."""
    return (FaultPlan(seed=1).engine_crash(10.0, engine=1,
                                           restart_after=1e6)
            .engine_hang(1e6, engine=0).trainer_crash(1e6, restart_after=1.0)
            .preprocess_fail(1e6).nan_step(1e6)
            .engine_slowdown(0.0, 1e6, engine=0).poison_prompt(3)
            .degrade_link(0.0, 1e6, drop_prob=0.2))


@pytest.mark.parametrize("resume", [False, True, "faults"],
                         ids=["two-steps", "max-lag-resumed", "fault-plan"])
def test_dropped_pipeline_frees_its_tensors(setup, no_gc, resume):
    task, cfg, params = setup
    pc = dict(PC, n_opt_steps=2, max_lag=1 if resume is True else None)
    faults = resume == "faults"
    if faults:
        pc["n_engines"] = 2
    p = PipelineRL(cfg, params, task, EngineConfig(n_slots=8, max_len=20),
                   PipelineConfig(**pc), fault_plan=_faults() if faults
                   else None, **CPU)
    log = p.run()
    assert len(log) == 2
    if resume is True:
        # pending events survive between runs while the pipeline lives
        assert len(p.loop) > 0
        assert len(p.run(3)) == 3
    if faults:
        assert len(p.loop) > 0 and p.fault_log
    refs = _tensors(p.trainer, p.engine, params)
    pipe = weakref.ref(p)
    del p, log
    assert pipe() is None
    assert [r() is None for r in refs] == [True, True, True]


def test_dropped_server_frees_its_tensors(setup, no_gc):
    """The Server's engine refers back to it only weakly (its prompt
    source, rejection callback, delivery callback and cost closures)."""
    task, cfg, params = setup
    srv = Server(cfg, params, EngineConfig(n_slots=2, max_len=20,
                                           cache="paged", page_size=4),
                 deadline=8.0, max_retries=1, **CPU)
    srv.connect_trainer(lambda: (params, 1))
    for _ in range(4):
        srv.submit(task.sample().prompt_ids)
    for i in range(6):
        if i == 2:
            srv.request_weight_update(streamed=True, n_chunks=4)
        srv.step()
    assert srv.quarantine(next(iter(srv.in_flight)))
    cache = weakref.ref(tree_flatten(srv.engine.state["cache"])[0][0])
    ref = weakref.ref(srv)
    del srv
    assert ref() is None and cache() is None


def test_dropped_conventional_frees_its_tensors(setup, no_gc):
    task, cfg, params = setup
    c = ConventionalRL(cfg, params, task, EngineConfig(n_slots=8, max_len=20),
                       ConventionalConfig(batch_size=4, g_steps=2,
                                          n_opt_steps=2, n_chips=8,
                                          pack_rows=2, pack_seq=48), **CPU)
    assert len(c.run()) == 2
    refs = _tensors(c.trainer, c.engine, params)
    del c
    assert [r() is None for r in refs] == [True, True, True]


def test_dropped_trainer_with_remat_frees_its_tensors(setup, no_gc):
    """Rematerialised layers go through torch's checkpoint, whose first
    call would import torch._dynamo and leave the calling frames (and the
    Trainer they hold) in a reference cycle; the model imports it first."""
    task, cfg, params = setup
    cfg = dataclasses.replace(cfg, remat=True)
    rng = np.random.default_rng(0)
    rollouts = [Rollout(tokens=rng.integers(0, cfg.vocab_size, 12).astype(
                            np.int32), prompt_len=4,
                        behavior_logprobs=np.zeros(12, np.float32),
                        reward=1.0, weight_versions=np.zeros(12, np.int32))
                for _ in range(4)]
    trainer = Trainer(cfg, params, **CPU)
    trainer.step(pack(rollouts, 2, 32))
    assert trainer.version == 1
    refs = [weakref.ref(tree_flatten(trainer.state.params)[0][0]),
            weakref.ref(tree_flatten(trainer.state.opt.m)[0][0])]
    del trainer
    assert [r() is None for r in refs] == [True, True]


def test_weak_method_does_not_keep_its_object():
    class Owner:
        def ping(self, t):
            return t + 1

    o = Owner()
    cb = weak_method(o.ping)
    assert cb(1) == 2
    ref = weakref.ref(o)
    del o
    assert ref() is None
    with pytest.raises(ReferenceError):
        cb(1)


def test_stages_hold_their_loop_weakly(setup):
    """A stage posts to the loop its owner keeps: the stage alone does not
    keep the loop (and its pending events) alive."""
    from repro_torch.core.events import TrainerStage
    loop = EventLoop()
    stage = TrainerStage(loop, trainer=None)
    stage.loop.post(1.0, lambda t: None)
    assert len(loop) == 1
    ref = weakref.ref(loop)
    del loop
    assert ref() is None
    with pytest.raises(ReferenceError):
        len(stage.loop)
