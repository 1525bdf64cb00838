"""The port's sharding layer and dry-run helpers against the JAX package's:
pure functions, no process group.

- every parameter leaf's logical axes (`param_logical`) equal the JAX
  `ParamDef.logical`, for every config;
- `logical_to_spec` over every parameter leaf and every
  `input_specs`/`input_logical` entry equals the JAX `PartitionSpec`, for
  every config x `SHAPES` x the meshes (16, 8), (2, 16, 8), (16, 16) and
  (2, 16, 16) (the JAX function reads only `mesh.axis_names` and
  `mesh.devices.shape`, so a stand-in mesh serves both sides at
  production sizes);
- `input_specs` / `input_logical`, `smoke_config`, `for_shape` and
  `model_flops_estimate` equal the JAX package's exactly;
- the JAX `test_substrate.py::test_spec_*` laws hold on the port;
- `constrain` is the identity outside a context, `placements_for` keeps
  the major-to-minor order, and a `Roofline` row has JAX's keys with
  `hlo_*` renamed `traced_*`.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_configs as jax_all_configs
from repro.configs import base as JB
from repro.models import model as JM
from repro.models.layers import ParamDef
from repro.roofline import analysis as JA
from repro.sharding import logical_to_spec as jax_spec
from repro_torch.configs import SHAPES, all_configs, get_config
from repro_torch.configs import base as TB
from repro_torch.models import model as M
from repro_torch.roofline import analysis as TA
from repro_torch.sharding import logical_to_spec, placements_for
from repro_torch.shardctx import constrain

ARCHS = sorted(all_configs())
MESHES = {"16x8": ((16, 8), ("data", "model")),
          "2x16x8": ((2, 16, 8), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {np.dtype(k): v for k, v in (
    (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
    (jnp.int32, torch.int32))}
MESH = SimpleNamespace(axis_names=("data", "model"),
                       devices=np.empty((16, 16)))
POD = SimpleNamespace(axis_names=("pod", "data", "model"),
                      devices=np.empty((2, 16, 16)))


def _mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _jax_logical(tree, path=""):
    if isinstance(tree, ParamDef):
        return {path: (tuple(tree.shape), tuple(tree.logical))}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_jax_logical(v, f"{path}/{k}"))
    return out


def _port_logical(cfg):
    out = {}

    def walk(node, path):
        if isinstance(node, tuple):
            out[path] = (tuple(node[0]), tuple(node[3]))
            return
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            walk(v, f"{path}/{k}")

    walk(M.param_entries(cfg), "")
    return out


def _jspec(spec):
    return tuple(spec)


def _flat_inputs(specs, logical, path=""):
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_flat_inputs(v, logical[k], f"{path}/{k}"))
        else:
            out[f"{path}/{k}"] = (tuple(v.shape), v.dtype, logical[k])
    return out


def test_registry_matches_jax():
    assert set(all_configs()) == set(jax_all_configs())
    assert list(SHAPES) == list(JAX_SHAPES)
    for k, s in SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(JAX_SHAPES[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_axes_equal_jax(arch):
    want = _jax_logical(JM.param_defs(jax_all_configs()[arch]))
    got = _port_logical(get_config(arch))
    assert got == want
    # param_logical is the same tree
    flat = {}

    def walk(node, path):
        if isinstance(node, tuple) and (not node or not isinstance(
                node[0], (tuple, dict, list))):
            flat[path] = node
            return
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            walk(v, f"{path}/{k}")

    walk(M.param_logical(get_config(arch)), "")
    assert flat == {k: v[1] for k, v in want.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch, mesh_name):
    """Every parameter and input spec, for every shape, on this mesh."""
    mesh = _mesh(mesh_name)
    jcfg, tcfg = jax_all_configs()[arch], get_config(arch)
    params = _jax_logical(JM.param_defs(jcfg))
    for path, (shape, logical) in params.items():
        assert logical_to_spec(logical, shape, mesh) == \
            _jspec(jax_spec(logical, shape, mesh)), path
        for rules in ({"p_embed": None, "p_embed_vocab": None},):
            assert logical_to_spec(logical, shape, mesh, rules) == \
                _jspec(jax_spec(logical, shape, mesh, rules)), path
    for sname in SHAPES:
        js, ts = JAX_SHAPES[sname], SHAPES[sname]
        jc, tc = JB.for_shape(jcfg, js), TB.for_shape(tcfg, ts)
        want = _flat_inputs(JB.input_specs(jc, js), JB.input_logical(jc, js))
        got = _flat_inputs(TB.input_specs(tc, ts), TB.input_logical(tc, ts))
        assert set(got) == set(want), sname
        for k, (shape, dtype, logical) in want.items():
            gshape, gdtype, glogical = got[k]
            assert (gshape, gdtype, glogical) == (shape,
                                                  DTYPES[np.dtype(dtype)],
                                                  logical), (sname, k)
            assert logical_to_spec(glogical, gshape, mesh) == \
                _jspec(jax_spec(logical, shape, mesh)), (sname, k)


def test_input_specs_are_meta():
    cfg = get_config("granite-3-2b")
    specs = TB.input_specs(cfg, SHAPES["decode_32k"])
    assert specs["cache"]["k"].device.type == "meta"
    assert specs["tokens"].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_for_shape_and_model_flops_equal_jax(arch):
    jcfg, tcfg = jax_all_configs()[arch], get_config(arch)
    js, ts = JB.smoke_config(jcfg), TB.smoke_config(tcfg)
    for f in dataclasses.fields(ts):
        if f.name in TB.PORT_OWN_FIELDS:
            continue
        a, b = getattr(ts, f.name), getattr(js, f.name)
        assert (a == DTYPES[np.dtype(b)]) if f.name == "dtype" \
            else a == b, f.name
    for sname in SHAPES:
        jc = JB.for_shape(jcfg, JAX_SHAPES[sname])
        tc = TB.for_shape(tcfg, SHAPES[sname])
        assert tc.attention_variant == jc.attention_variant
        assert tc.supports_long_decode == jc.supports_long_decode
        assert TA.model_flops_estimate(tc, SHAPES[sname]) == \
            JA.model_flops_estimate(jc, JAX_SHAPES[sname])
    assert TB.CACHE_LOGICAL == JB.CACHE_LOGICAL


def test_spec_basic_tp():
    assert logical_to_spec(("p_embed", "p_mlp"), (4096, 14336), MESH) == \
        ("data", "model")


def test_spec_divisibility_fallback():
    # 8 kv heads cannot shard over model=16 -> replicated
    assert logical_to_spec(("p_kv_heads",), (8,), MESH) == (None,)


def test_spec_axis_used_once():
    assert logical_to_spec(("batch", "cache_seq"), (128, 32768), MESH) == \
        ("data", "model")
    assert logical_to_spec(("batch", "cache_seq"), (1, 524288), MESH) == \
        (None, ("data", "model"))


def test_spec_multi_axis_batch():
    assert logical_to_spec(("batch", "seq"), (256, 4096), POD) == \
        (("pod", "data"), None)


@given(st.integers(1, 4096), st.integers(1, 4096))
@settings(max_examples=60, deadline=None)
def test_spec_never_invalid(d1, d2):
    sizes = dict(zip(MESH.axis_names, MESH.devices.shape))
    spec = logical_to_spec(("p_embed", "p_mlp"), (d1, d2), MESH)
    for dim, entry in zip((d1, d2), spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        total = 1
        for a in axes:
            total *= sizes[a]
        assert dim % total == 0


def test_constrain_is_identity_outside_a_context():
    x = torch.randn(4, 8)
    assert constrain(x, ("batch", "embed")) is x


def test_placements_keep_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements_for((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements_for((None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        placements_for((("data", "pod"),), mesh)


def test_roofline_row_keys_equal_jax():
    j = JA.Roofline("x", 1.0, 2.0, 3.0, {"all-gather": 3}, 8).row()
    t = TA.Roofline("x", 1.0, 2.0, 3.0, {"all-gather": 3}, 8).row()
    rename = {"hlo_gflops_per_dev": "traced_gflops_per_dev",
              "hlo_gbytes_per_dev": "traced_gbytes_per_dev"}
    assert list(t) == [rename.get(k, k) for k in j]
