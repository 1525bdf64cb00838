"""The architectures the benchmark knows, one module a published
`model_type`: a configuration file whose `model_type` is `<t>` is run
through `rlbench/arch/<t>.py`. A module holds all that the harness needs
of its architecture and imports nothing of the program:

- `leaf_specs(c)`: the port's weight layout, (path, shape, dtype name,
  init scale) of every leaf in draw order (`rlbench/weights.py`);
- `param_count(c, active_only)`: the analytic parameter count
  (`rlbench/flops.py`);
- `Model(c, p, act=None, quant=None)`: the plain float32 reference on a
  tree in any type, with `hidden(tokens, positions, cache, offset,
  remat)`, `token_logprobs`, `values`; `quant` rounds each weight as read
  and `act` each product's inputs (the control);
- `PORT_FIELDS`: the port's `ModelConfig` field -> the file key that holds
  it; `PORT_LAYOUT`: the other fields the port's config of this layout
  holds at other than their defaults, with their values (`rlbench/port.py`);
- `TINY`: the file keys set to the CPU rehearsal's tiny sizes
  (`rlbench/rehearse.py`).
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

PACKAGE = Path(__file__).resolve().parent
DIR = PACKAGE  # where `of` looks


def load(model_type: str, directory: Optional[Path] = None) -> ModuleType:
    """The module `<directory>/<model_type>.py` (`DIR` by default), loaded
    once a process."""
    directory = Path(directory or DIR).resolve()
    path = directory / f"{model_type}.py"
    if not path.is_file():
        known = sorted(p.stem for p in directory.glob("[!_]*.py"))
        raise KeyError(f"no architecture {model_type!r} in {directory}; "
                       f"known: {known}")
    name = (f"rlbench.arch.{model_type}" if directory == PACKAGE
            else f"rlbench_arch_{model_type}_{abs(hash(str(path)))}")
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return mod


def of(c: Dict) -> ModuleType:
    """The architecture module of configuration `c`: its `model_type` in
    `DIR`."""
    return load(c["model_type"], DIR)


def model(c: Dict, p: Dict, act=None, quant=None):
    """The plain float32 reference of configuration `c` on weights `p`."""
    return of(c).Model(c, p, act, quant)
