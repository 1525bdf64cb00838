"""Refill's chunked prefill on a compact batch of the rows it admitted, on
the CPU, float32: one GRPO group is admitted while another group's slots
are mid-decode. The compact batch writes the K/V of the every-slot call
(GQA's k and v, MLA's latent and rope key, a hybrid's attention leaves and
its conv and SSD rows) into the leader's pages (paged) or the prefilled
rows (slot cache), and not one other byte of the cache. An MoE config,
whose expert capacity couples the rows of a call, and a mesh engine, whose
slot cache is split on its batch axis, keep the every-slot call."""
import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import tiny
from repro_torch.configs.base import smoke_config
from repro_torch.configs import get_config
from repro_torch.core.rollout import (_PAGED_LEAVES, EngineConfig,
                                      GenerationEngine)
from repro_torch.data.math_task import Problem
from repro_torch.models import model as TM

CONFIGS = {
    "gqa": lambda: tiny.config(vocab_size=64, d_model=64),
    # deepseek-v3's latent attention on dense layers: experts would couple
    # the rows (the moe case below)
    "mla": lambda: dataclasses.replace(
        smoke_config(get_config("deepseek-v3-671b")), n_experts=0),
    "hybrid": lambda: smoke_config(get_config("hymba-1.5b")),
    "moe": lambda: smoke_config(get_config("granite-moe-1b-a400m")),
}
H, CHUNK = 8, 4
# the first group decodes while the second enters: its prompt (P-1 = 10)
# takes three chunks and three pages of 4
FIRST, SECOND = list(range(3, 9)), list(range(5, 16))


@pytest.fixture(autouse=True)
def recorder_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _engine(name, cache, mesh=None):
    torch.manual_seed(0)
    cfg = CONFIGS[name]()
    params = TM.init_params(cfg, seed=0, device="cpu")
    ec = EngineConfig(n_slots=H, max_len=32, prefill_chunk=CHUNK,
                      cache=cache, page_size=CHUNK, prefix_sharing=True,
                      temperature=1.0, eos_id=-1)
    queue = collections.deque(Problem(list(FIRST), 0) for _ in range(4))
    eng = GenerationEngine(cfg, params, ec,
                           lambda: queue.popleft() if queue else None,
                           seed=1, device="cpu", mesh=mesh)
    eng.refill()
    for _ in range(3):
        eng.step()
    queue.extend(Problem(list(SECOND), 0) for _ in range(4))
    return cfg, params, eng


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _allowed(eng, leaf, rows):
    """Where the prefill may write `leaf`: the prefilled rows' prefix pages
    of a page pool, else their rows."""
    if eng._paged and leaf in _PAGED_LEAVES:
        ok = torch.zeros(eng.allocator.n_pages, dtype=torch.bool)
        need = -(-(len(SECOND) - 1) // eng.allocator.page_size)
        ok[eng._bt[rows, :need].long().flatten()] = True
        return ok
    ok = torch.zeros(H, dtype=torch.bool)
    ok[rows] = True
    return ok


@pytest.mark.parametrize("cache", ["paged", "slots"])
@pytest.mark.parametrize("name", ["gqa", "mla", "hybrid"])
def test_compact_prefill_writes_the_every_slot_bytes(name, cache):
    cfg, params, eng = _engine(name, cache)
    mask, new_plen, prefill_mask, forks = eng._admit(0.0)
    rows = np.nonzero(prefill_mask)[0]
    assert len(rows) == (1 if cache == "paged" else 4)
    assert eng.n_active == 8 and len(rows) < H
    before = _clone(eng.state["cache"])
    # the every-slot call on a copy of the admitted state
    st = eng.state
    oracle = _clone(before)
    admit = torch.from_numpy(prefill_mask)
    for off in range(0, len(SECOND) - 1, CHUNK):
        TM.prefill_chunk(params, st["tokens"], st["prompt_len"], off, admit,
                         oracle, cfg, chunk=CHUNK, block_tables=eng._bt)
    # paged, the leader runs with its three forks, which write nothing
    assert eng._prefill(new_plen, mask, prefill_mask) == (3, 4)
    got = st["cache"]
    assert set(got) == set(oracle)
    for k in got:
        # the leader's bytes as the every-slot call writes them
        assert torch.equal(got[k], oracle[k]), k
        # written only where the prefilled rows own the cache
        changed = (got[k] != before[k]).flatten(2).any(-1).any(0)
        assert changed.any(), k
        assert not (changed & ~_allowed(eng, k, rows)).any(), k
        if cache == "slots" and k in _PAGED_LEAVES:
            # a row's positions past its prompt keep their bytes
            P = len(SECOND)
            assert torch.equal(got[k][:, :, P - 1:], before[k][:, :, P - 1:])


@pytest.mark.parametrize("cache", ["paged", "slots"])
@pytest.mark.parametrize("name", ["gqa", "moe"])
def test_refill_runs_the_admitted_rows_unless_rows_are_coupled(name, cache):
    """The span's `rows` and `prefill_row_tokens` count the rows each chunk
    ran: the four rows the refill admitted, every slot for an MoE config."""
    _, _, eng = _engine(name, cache)
    rt0, n0 = eng.prefill_row_tokens, eng.prefill_invocations
    trace.enable()
    assert eng.refill() == 4
    spans = [r for r in trace.take() if r[0] == "engine.refill.prefill"]
    rows = H if name == "moe" else 4
    assert [(s[4]["rows"], s[4]["chunks"]) for s in spans] == [(rows, 3)]
    assert eng.prefill_invocations - n0 == 3
    assert eng.prefill_row_tokens - rt0 == 3 * rows * CHUNK


@contextlib.contextmanager
def _one_rank_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("model",))
    finally:
        dist.destroy_process_group()


def test_mesh_engine_keeps_the_every_slot_call():
    with _one_rank_mesh() as mesh:
        _, _, eng = _engine("gqa", "slots", mesh=mesh)
        trace.enable()
        assert eng.refill() == 4
        spans = [r for r in trace.take() if r[0] == "engine.refill.prefill"]
    assert [(s[4]["rows"], s[4]["chunks"]) for s in spans] == [(H, 3)]
