"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
JAX nor anything of the JAX package `repro`, and the port's entry points run
on the card unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import (ConventionalConfig, ConventionalRL, PipelineConfig,
                         PipelineRL)
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.core.preprocess import PreprocessConfig, Preprocessor
from repro_torch.core.rollout import EngineConfig, GenerationEngine
from repro_torch.core.trainer import Trainer, init_train_state
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_repro():
    """In a fresh interpreter (this one has JAX loaded by conftest), import
    every module of the port and the module of chip_smoke.py."""
    code = """
import importlib, pkgutil, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("SSM", "repro_torch.models.ssm" in sys.modules,
      "repro_torch.configs.mamba2_2_7b" in sys.modules)
print("NEW", "repro_torch.models.moe" in sys.modules, all(
    "repro_torch.configs." + m in sys.modules for m in (
        "hymba_1_5b", "granite_moe_1b", "qwen3_32b", "phi3_mini_3_8b",
        "phi3_vision_4_2b", "musicgen_medium")))
print("A7", all(m in sys.modules for m in (
    "repro_torch.core.serving", "repro_torch.core.evaluator")))
print("A7D", all("repro_torch." + m in sys.modules for m in (
    "sharding", "shardctx", "kernels.sharded", "launch.mesh",
    "launch.steps", "launch.dryrun", "launch.train", "roofline.analysis",
    "roofline.calibrate")))
print("A7E", "repro_torch.launch.meshrt" in sys.modules)
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n_loaded = int(out.stdout.split("LOADED ")[1].split()[0])
    assert n_loaded >= 30
    assert "SSM True True" in out.stdout, out.stdout
    assert "NEW True True" in out.stdout, out.stdout
    assert "A7 True" in out.stdout, out.stdout
    assert "A7D True" in out.stdout, out.stdout
    assert "A7E True" in out.stdout, out.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_entry_points_default_to_the_card(monkeypatch):
    """With no CUDA device the defaults raise instead of running quietly on
    the CPU; `device="cpu"` is the caller's explicit choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny")
    params = TM.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(cfg, params, EngineConfig(), lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(params_to_numpy(params), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Preprocessor(cfg, params, PreprocessConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(params)
    state = init_train_state(params, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_from_numpy(train_state_to_numpy(state), cfg)
    assert Trainer(cfg, params, device="cpu").device.type == "cpu"
    assert Preprocessor(cfg, params, PreprocessConfig(),
                        device="cpu").device.type == "cpu"
    eng = GenerationEngine(cfg, params, EngineConfig(), lambda: None,
                           device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(ValueError, match="params on"):
        GenerationEngine(cfg, params, EngineConfig(), lambda: None,
                         device="meta")


def test_orchestration_entry_points_default_to_the_card(monkeypatch):
    """PipelineRL and ConventionalRL build their Trainer and engines on the
    card unless told otherwise; with `device="cpu"` every piece is on the
    CPU, the paged engine included."""
    from repro_torch.data.math_task import MathTask
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = MathTask()
    cfg = get_config("tiny")
    params = TM.init_params(cfg, seed=0, device="cpu")
    ec = EngineConfig(n_slots=2, max_len=16, cache="paged",
                      paged_attention="kernel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineRL(cfg, params, task, ec, PipelineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConventionalRL(cfg, params, task, ec, ConventionalConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(cfg, params, ec, lambda: None)
    p = PipelineRL(cfg, params, task, ec, PipelineConfig(n_engines=2),
                   device="cpu")
    assert p.trainer.device.type == "cpu"
    assert all(e.device.type == "cpu" and e._bt.device.type == "cpu"
               for e in p.engines)
    c = ConventionalRL(cfg, params, task, ec, ConventionalConfig(),
                       device="cpu")
    assert c.trainer.device.type == c.engine.device.type == "cpu"


def test_server_and_evaluator_default_to_the_card(monkeypatch):
    """The request Server and the Evaluator build their engines on the card
    unless told otherwise, and raise without one."""
    from repro_torch import Evaluator, Server
    from repro_torch.data.math_task import MathTask
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = MathTask(max_operand=3, ops="+")
    cfg = get_config("tiny")
    params = TM.init_params(cfg, seed=0, device="cpu")
    ec = EngineConfig(n_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg, params, ec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(cfg, task, n_problems=2)
    srv = Server(cfg, params, ec, device="cpu")
    assert srv.device.type == srv.engine.device.type == "cpu"
    ev = Evaluator(cfg, task, n_problems=2, max_len=8, device="cpu")
    assert ev.evaluate(params)["n"] >= 2


def test_cli_defaults_to_the_card(monkeypatch):
    """`python -m repro_torch.launch.train` runs on the card unless
    `--device cpu` is given, and raises without one."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
