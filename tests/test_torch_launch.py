"""The port's RL CLI (`repro_torch.launch.train.main`) against the JAX
package's (`repro.launch.train.main`): the default tiny pipeline for 2
steps on the CPU, from the same weights (the JAX CLI's seed-0 init,
converted) and at the twins' greedy temperature (each CLI's
`EngineConfig` is given temperature 1e-4 for the run: the two packages'
samplers draw from different random streams), prints equal step lines (version, simulated time, max lag,
reward and ESS equal; loss within 1e-4, read from `--log-out`) and equal
summary lines. Three runs: the pipeline, the pipeline under a fault plan,
and conventional RL."""
import functools
import json
import os
import re
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs.tiny import config as jax_tiny
from repro.data.math_task import MathTask as JaxTask
from repro.core.rollout import EngineConfig as JaxEngineConfig
from repro.launch import train as JT
from repro.models import model as JM
from repro.sharding import tree_values
from repro_torch.convert import params_from_numpy
from repro_torch.core.rollout import EngineConfig
from repro_torch.launch import train as TT

from torch_twin import GREEDY, one_thread

RUNS = {
    "pipeline": ["--steps", "2"],
    "fault-plan": ["--steps", "2", "--fault-plan", "engine:0@3000r500"],
    "conventional": ["--steps", "2", "--mode", "conventional"],
}
STEP = re.compile(r"step +(\d+) +t= *(\d+)f +reward=(\S+) +ess=(\S+) +"
                  r"max_lag=(\S+) +loss=(\S+)")


def _jax_params():
    task = JaxTask(max_operand=3, ops="+")
    cfg = jax_tiny(vocab_size=task.tok.vocab_size, d_model=96, n_layers=2)
    return jax.tree.map(np.asarray, tree_values(
        JM.init_params(cfg, jax.random.PRNGKey(0))))


def _run(module, engine_config, argv, log_path):
    """stdout lines of one CLI run (argv through sys.argv, as a shell
    gives it), without the path-bearing last line."""
    import contextlib
    import io

    buf = io.StringIO()
    old = sys.argv, module.EngineConfig
    sys.argv = ["train"] + argv + ["--log-out", log_path]
    module.EngineConfig = functools.partial(engine_config,
                                            temperature=GREEDY)
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv, module.EngineConfig = old
    return [l for l in buf.getvalue().splitlines()
            if l and not l.startswith("log ->")]


@functools.lru_cache(maxsize=None)
def _both(name):
    tmp = tempfile.mkdtemp(prefix="cli_")
    argv = RUNS[name]
    jlines = _run(JT, JaxEngineConfig, argv, os.path.join(tmp, "jax.json"))
    tree = _jax_params()
    old = TT.initial_params
    TT.initial_params = lambda cfg, seed, device: params_from_numpy(
        tree, cfg, device=device)
    try:
        with one_thread():
            tlines = _run(TT, EngineConfig, argv + ["--device", "cpu"],
                          os.path.join(tmp, "port.json"))
    finally:
        TT.initial_params = old
    logs = [json.load(open(os.path.join(tmp, f)))
            for f in ("jax.json", "port.json")]
    return jlines, tlines, logs


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_step_lines_match_jax(name):
    jlines, tlines, (jlog, tlog) = _both(name)
    jsteps = [STEP.match(l).groups() for l in jlines if STEP.match(l)]
    tsteps = [STEP.match(l).groups() for l in tlines if STEP.match(l)]
    assert len(jsteps) == 2 and len(tsteps) == 2
    # version, simulated time, reward, ess and max lag as printed
    assert [s[:5] for s in tsteps] == [s[:5] for s in jsteps]
    assert len(tlog) == len(jlog)
    for a, b in zip(tlog, jlog):
        assert a["version"] == b["version"]
        assert abs(a["loss"] - b["loss"]) <= 1e-4
    # the summary lines (broadcast, faults, health) are equal
    assert [l for l in tlines if not STEP.match(l)] == \
        [l for l in jlines if not STEP.match(l)]
    if name == "fault-plan":
        assert any(l.startswith("faults:") for l in tlines)
