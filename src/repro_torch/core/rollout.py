"""Continuous-batching generation engine with in-flight weight updates —
the Actor of PipelineRL (Algorithm 2), on PyTorch and CUDA.

The engine keeps H static slots, each with its own write index into a
preallocated slot KV cache. Finished sequences retire and their slot is
refilled with a new prompt, which enters the cache by chunked prefill. An
in-flight weight update swaps the behavior weights μ between decode
steps; the KV cache of in-progress sequences stays *stale*, exactly the
paper's mechanism (§5.1 shows this is safe; `recompute_kv=True` reproduces
its ablation). Every sampled token is stamped with its behavior logprob
and the weight version it was sampled under.

Device state is updated in place, with autograd off: the engine never
builds a graph, even when it is handed parameters that require grad. The
only device-to-host read of a decode step is the (H,) `finished` mask;
the scheduling scalars have numpy mirrors on the host.

`EngineConfig.cache="paged"` replaces the slot cache with a page pool
addressed through a ref-counted block table (`kernels/paged_cache.py`):
admission is costed in pages, a GRPO group's identical prompts are
prefilled once and forked copy-on-write, and page exhaustion preempts the
least-progressed slot. The slot engine stays the oracle that paged
rollouts match bit for bit. An attention-free (SSM) config has nothing to
page: it keeps O(1) conv and SSD state per slot and runs the slot state
machine under either setting, admission costing 0 pages. A hybrid config
pages its attention leaves and keeps its conv and SSD rows per slot: a
fork takes the leader's pages and a copy of its post-prefill rows. An MLA
config's attention leaves are its latent `c_kv` and rope key `k_rope`.
An interleaved config does as a hybrid one: its pool stacks its
attention layers and its rows its Mamba2 layers.

`mesh=` places the engine on a `DeviceMesh` (the JAX package's real-mesh
engine): the parameters take the generation layout of their logical axes
(`sharding.tree_shardings`), the slot cache follows `CACHE_LOGICAL`, and
the page pool and the scheduling vectors are replicated (each rank of the
mesh holds a whole copy); every model call runs under
`shardctx.sharding_context`. torch is multi-controller: every rank of the
process group runs the same host program, so a rank outside the engine's
mesh keeps the engine's host bookkeeping and runs none of its device work,
and each decode step's host-visible outputs (the `finished` mask, the
finished rows' tokens and logprobs) are broadcast over the whole group
from the mesh's first rank, so that every rank reaches the same decisions
(`lockstep`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import (ModelConfig, effective_cache_len,
                                      kv_cache_specs, paged_cache_specs,
                                      paged_layout)
from repro_torch.core.weights import (chunk_spans, chunk_token, span_bytes,
                                      stream_digest, tree_bytes, tree_flatten,
                                      tree_unflatten)
from repro_torch.data.math_task import MathTask, Problem
from repro_torch.data.packing import Rollout
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.paged_cache import (BlockTables, OutOfPages,
                                             PageAllocator)
from repro_torch.models import model as M
from repro_torch.shardctx import full, is_distributed


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 16            # H, the generation batch size
    max_len: int = 64            # prompt + completion budget per sequence
    temperature: float = 1.0
    eos_id: int = 2
    pad_id: int = 0
    # chunked-prefill admission: newly admitted prompts run through
    # batched `prefill_chunk`-token forwards that write K/V straight into
    # the slot cache — ceil((P-1)/chunk) model invocations per prompt
    # instead of P-1 one-token decode steps. 0 falls back to the legacy
    # token-at-a-time forcing loop. The effective chunk is reduced until it
    # divides max_len and the attention cache length, so chunk windows
    # never cross the cache end and ring-buffer writes stay contiguous.
    prefill_chunk: int = 16
    # admission policy for prompts longer than max_len-2: "reject" drops
    # the prompt and counts it in `prompts_rejected` (the task reward is
    # computed against the FULL problem); "truncate" clips and admits,
    # counted in `prompts_truncated`.
    long_prompt: str = "reject"
    # "slots": one contiguous max_len stripe per slot (the oracle).
    # "paged": the attention leaves become page pools addressed through a
    # ref-counted block table: short requests stop reserving max_len of
    # cache, a GRPO group's prompt is prefilled once and forked
    # copy-on-write, and admission is costed in pages.
    cache: str = "slots"
    # logical tokens per page (reduced until it divides the cache length)
    page_size: int = 16
    # physical pages in the pool, including the reserved trash page 0.
    # 0 = auto: n_slots * blocks_per_slot + 1, the slot cache's footprint
    # (no eviction pressure); fewer pages rely on preemption.
    n_pages: int = 0
    # prefill a GRPO group's identical prompt once and fork the rest over
    # shared pages (paged mode with chunked prefill only)
    prefix_sharing: bool = True
    # paged decode read path: "gather" runs the slot engine's attention on
    # each slot's gathered view; "kernel" reads the pool through the block
    # table (`flash_decode_paged`, equal to "gather" bit for bit)
    paged_attention: str = "gather"


# backstop for refill's reject-retry loop: after this many rejections in
# one refill call the engine stops pulling for the tick
_MAX_REJECTS_PER_REFILL = 1024


def _zero_cache(cfg: ModelConfig, n_slots: int, max_len: int, device):
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in kv_cache_specs(cfg, n_slots, max_len).items()}


def _zero_paged_cache(cfg: ModelConfig, n_slots: int, max_len: int,
                      n_pages: int, page_size: int, device):
    specs = paged_cache_specs(cfg, n_slots, max_len, n_pages, page_size)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in specs.items()}


# the attention cache leaves (GQA's k and v, MLA's latent c_kv and
# k_rope), page pools in paged mode; the SSM's conv and ssd keep one row
# per slot
_PAGED_LEAVES = ("k", "v", "c_kv", "k_rope")


def _attention_leaves(cache) -> List[str]:
    return [k for k in _PAGED_LEAVES if k in cache]


def _paged_ring_view(cache, block_tables):
    """Gather pool leaves (L,NP,PS,...) into slot-layout (L,H,CL,...)
    copies through the block table; SSM leaves (already per slot) pass
    through as they are."""
    bt = block_tables.long()
    return {k: v[:, bt].flatten(2, 3) if k in _PAGED_LEAVES else v
            for k, v in cache.items()}


def _admit_impl(st: Dict[str, Any], new_tokens, new_plen, new_ncached,
                admit_mask) -> None:
    """Scatter fresh prompt rows into the engine state (in place). The only
    host-to-device traffic is the (H,T) prompt buffer and three (H,)
    vectors. admit_mask: (H,) bool, True where a new prompt enters. The
    SSM state of refilled slots is zeroed in place: the attention cache is
    masked by count, but recurrent state would carry a retired sequence
    into the next."""
    m = admit_mask
    st["tokens"] = torch.where(m[:, None], new_tokens, st["tokens"])
    st["lp"] = torch.where(m[:, None], torch.zeros_like(st["lp"]), st["lp"])
    st["n_cached"] = torch.where(m, new_ncached, st["n_cached"])
    st["prompt_len"] = torch.where(m, new_plen, st["prompt_len"])
    st["active"] = st["active"] | m
    for k in ("conv", "ssd"):
        if k in st["cache"]:
            leaf = st["cache"][k]                          # (L,H,...)
            leaf.masked_fill_(m.reshape((1, -1) + (1,) * (leaf.dim() - 2)),
                              0)


def _engine_step(params, st: Dict[str, Any], cfg: ModelConfig,
                 ec: EngineConfig, generator: torch.Generator,
                 block_tables=None):
    """One token for every active slot, state updated in place. st: tokens
    (H,T), lp (H,T), n_cached (H,), prompt_len (H,), active (H,) bool,
    cache. block_tables: (H,NB) in paged mode; the host guarantees before
    every step that each active slot's write block is an exclusively owned
    page and that inactive rows point at the trash page. Returns the (H,)
    bool `finished` mask, on the device."""
    H, T = st["tokens"].shape
    idx = torch.arange(H, device=st["tokens"].device)
    n_cached = st["n_cached"]
    cur_tok = st["tokens"][idx, n_cached][:, None]                # (H,1)
    positions = n_cached[:, None]                                 # (H,1)
    out = M.decode_step(params, cur_tok, positions, st["cache"], n_cached,
                        cfg, ring=False, block_tables=block_tables,
                        paged_kernel=ec.paged_attention == "kernel")
    # on a mesh the logits are gathered whole: sampling is host-visible
    logits = full(out["logits"])[:, 0] / max(ec.temperature, 1e-6)
    logp = torch.log_softmax(logits.float(), dim=-1)

    # Gumbel-max draw on the engine's generator (the same law as
    # jax.random.categorical, not the same bits)
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    sampled = torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)

    next_idx = n_cached + 1
    in_prompt = next_idx < st["prompt_len"]
    wpos = torch.clamp(next_idx, max=T - 1)
    forced = st["tokens"][idx, wpos]
    next_tok = torch.where(in_prompt, forced, sampled)
    tok_lp = logp.gather(1, next_tok[:, None])[:, 0]
    tok_lp = torch.where(in_prompt, torch.zeros_like(tok_lp), tok_lp)

    active = st["active"]
    write = active & (next_idx < T)
    st["tokens"][idx, wpos] = torch.where(write, next_tok, forced)
    st["lp"][idx, wpos] = torch.where(write, tok_lp, st["lp"][idx, wpos])

    finished = active & ~in_prompt & (
        (next_tok == ec.eos_id) | (next_idx >= T - 1))
    st["n_cached"] = torch.where(active, next_idx, n_cached)
    st["active"] = active & ~finished
    return finished


def _recompute_impl(params, st: Dict[str, Any], cfg: ModelConfig) -> None:
    """Recompute the attention cache of every slot under `params` (the
    §5.1 ablation), in place. Entries at positions >= n_cached are garbage
    in both the old and the new cache (masked by count), so a full
    overwrite is safe. Recurrent SSM state is not recomputed (nor is it in
    the JAX package), so an attention-free config runs no forward at all."""
    leaves = _attention_leaves(st["cache"])
    if not leaves:
        return
    H, T = st["tokens"].shape
    dev = st["tokens"].device
    positions = torch.arange(T, device=dev)[None].expand(H, T)
    out = M.forward(params, st["tokens"], positions, cfg, return_cache=True,
                    logits=False)
    for k in leaves:
        full, dst = out["cache"][k], st["cache"][k]     # (L,H,T,...), (L,H,CL,...)
        if full.shape == dst.shape:
            dst.copy_(full)
            continue
        # ring cache (CL < T): slot j holds the most recent position
        # p <= n_cached-1 with p ≡ j (mod CL), as the sequential decode
        # loop would have written it; slots past a row's frontier clamp
        # to dead positions that count-based masking never reads
        CL = dst.shape[2]
        nc = st["n_cached"][None, :, None]                 # (1,H,1)
        j = torch.arange(CL, device=dev)[None, None]       # (1,1,CL)
        p = torch.clamp((nc - 1) - torch.remainder(nc - 1 - j, CL), 0, T - 1)
        index = p.reshape(p.shape + (1,) * (full.dim() - 3)).expand(
            full.shape[:2] + (CL,) + full.shape[3:])
        dst.copy_(torch.gather(full, 2, index))


def _recompute_impl_paged(params, st: Dict[str, Any], block_tables,
                          cfg: ModelConfig) -> None:
    """Paged twin of `_recompute_impl`: recompute each slot's ring view,
    then scatter it into the slot's pages. The caller has unshared every
    block, so no page is written twice except the trash page (unallocated
    entries, never read unmasked)."""
    view = _paged_ring_view(st["cache"], block_tables)
    _recompute_impl(params, dict(st, cache=view), cfg)
    bt = block_tables.long()
    for k in _attention_leaves(st["cache"]):
        pool, v = st["cache"][k], view[k]
        pool[:, bt] = v.reshape(v.shape[:2] + tuple(bt.shape[1:])
                                + (pool.shape[2],) + v.shape[3:])


class GenerationEngine:
    """H-slot continuous-batching engine (Algorithm 2, Actor). Runs on the
    card unless `device="cpu"` is asked for; `params` must already live on
    that device (`models.model.init_params`, `convert.params_from_numpy`).
    `mesh`/`rules` place it on a DeviceMesh (module docstring); the
    parameters given may then be plain tensors (the same on every rank) or
    distributed ones on any mesh of the group (the trainer's)."""

    def __init__(self, cfg: ModelConfig, params, ec: EngineConfig,
                 prompt_source: Callable[[], Optional[Problem]],
                 seed: int = 0, device="cuda", mesh=None, rules=None):
        self.device = resolve_device(device)
        if ec.cache not in ("slots", "paged"):
            raise ValueError(f"EngineConfig.cache: {ec.cache!r}")
        if ec.paged_attention not in ("gather", "kernel"):
            raise ValueError(
                f"EngineConfig.paged_attention: {ec.paged_attention!r}")
        self.cfg, self.ec = cfg, ec
        # real-mesh placement: each leaf's placements on `mesh`, in
        # `tree_flatten` order; executed transfers land in `wexec_log`:
        # {"kind": "atomic"|"chunk", "version", "k", "nbytes", "seconds"}
        self.mesh, self.rules = mesh, rules
        self._pshard_leaves: Optional[List[Any]] = None
        self.wexec_log: List[Dict[str, Any]] = []
        # the host outputs broadcast to every rank: calls and bytes
        self.lockstep = {"broadcasts": 0, "bytes": 0}
        self._runs = True         # this rank runs the engine's device work
        if mesh is not None:
            from repro_torch.launch.steps import abstract_params
            from repro_torch.sharding import placements_for, spec_for
            self._runs = mesh.get_coordinate() is not None
            self._src = int(mesh.mesh.reshape(-1)[0])
            self._pshard_leaves = [
                placements_for(spec_for(a, mesh, rules), mesh)
                for a in tree_flatten(abstract_params(cfg))[0]]
            params = self._place(params)
        self._check_params(params)
        self.params = params      # behavior weights μ
        self.version = 0          # trainer version of μ
        self.prompt_source = prompt_source
        H, T = ec.n_slots, ec.max_len
        dev = self.device
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(int(seed))
        # paged KV cache: page pool + block tables. The block table lives on
        # the host and is mirrored to the device once per change
        # (`_bt_dirty`), not once per step. An attention-free config has
        # nothing to page and runs the slot state machine.
        self._paged = ec.cache == "paged" and cfg.has_attention
        self.allocator: Optional[PageAllocator] = None
        self.tables: Optional[BlockTables] = None
        self._bt: Optional[torch.Tensor] = None
        self._bt_dirty = False
        self._deferred: "collections.deque[Problem]" = collections.deque()
        if self._paged:
            ps, nb = paged_layout(cfg, T, ec.page_size)
            n_pages = ec.n_pages or H * nb + 1
            if n_pages - 1 < nb:
                # a lone sequence must be able to fill its table even after
                # preempting everyone else, or eviction cannot terminate
                raise ValueError(
                    f"n_pages={n_pages} cannot back one full sequence "
                    f"({nb} blocks + trash page)")
            self.allocator = PageAllocator(n_pages, ps)
            self.tables = BlockTables(H, nb, self.allocator)
            if self._runs:
                self._bt = torch.zeros((H, nb), dtype=torch.int32,
                                       device=dev)
            cache = (_zero_paged_cache(cfg, H, T, n_pages, ps, dev)
                     if self._runs else None)
        else:
            cache = _zero_cache(cfg, H, T, dev) if self._runs else None
        if mesh is not None and self._runs and not self._paged:
            cache = self._place_cache(cache)
        self.state: Dict[str, Any] = {
            "tokens": torch.zeros((H, T), dtype=torch.long, device=dev),
            "lp": torch.zeros((H, T), dtype=torch.float32, device=dev),
            "n_cached": torch.zeros((H,), dtype=torch.long, device=dev),
            "prompt_len": torch.ones((H,), dtype=torch.long, device=dev),
            "active": torch.zeros((H,), dtype=torch.bool, device=dev),
            "cache": cache,
        } if self._runs else {}
        # host-side bookkeeping
        self.problems: List[Optional[Problem]] = [None] * H
        self.ver_buf = np.zeros((H, T), np.int32)
        self.started_at = np.zeros(H, np.float64)
        self.tokens_generated = 0
        # host mirrors of the scheduling scalars — the step/refill hot loop
        # never reads engine state back from the device except `finished`
        self._host_active = np.zeros(H, bool)
        self._host_ncached = np.zeros(H, np.int64)
        self._host_prompt_len = np.ones(H, np.int64)
        # attention cache length (None for an attention-free config); a
        # ring buffer when < T. Paged leaves are (L,NP,PS,...) pools, so the
        # logical length comes from the layout.
        self._cache_len: Optional[int] = None
        if self._paged:
            self._cache_len = self.tables.n_blocks * self.allocator.page_size
            assert self._cache_len == effective_cache_len(cfg, T)
        elif cfg.has_attention:
            self._cache_len = effective_cache_len(cfg, T)
        # the effective chunk divides T (chunk windows never cross the
        # token buffer end), the cache length (ring writes stay contiguous)
        # and, paged, the page size (a chunk lands in one logical block)
        chunk = max(int(ec.prefill_chunk), 0)
        if chunk:
            cl = self._cache_len or T
            ps = self.allocator.page_size if self._paged else cl
            chunk = min(chunk, T, cl, ps)
            while T % chunk or cl % chunk or ps % chunk:
                chunk -= 1
        self.prefill_chunk_size = chunk
        self.prefill_invocations = 0       # chunked-prefill model calls
        self.prefill_tokens = 0            # prompt tokens admitted via prefill
        self.last_admit_prefill_tokens = 0
        # paged-mode accounting
        self.prompt_prefills = 0           # rows actually prefilled (leaders)
        self.prefix_forks = 0              # rows admitted by COW fork
        self.last_admit_pages = 0          # pages allocated by last refill
        self.slots_preempted = 0           # page-exhaustion evictions
        self.pages_copied = 0              # COW page copies made on device
        # waste of chunked prefill: each chunk runs its rows (those the
        # refill admitted, or every slot: `_prefill`), while only the
        # prefilled rows' prompt tokens (`prefill_tokens`) need it
        self.prefill_row_tokens = 0        # rows x chunk of each chunk call
        # host<->device transfers in step, refill and the page code that
        # make the host wait for the card (device reads, pageable copies)
        self.blocking_transfers = 0
        # rollout ids: each admission takes the next, carried on its Rollout
        self.next_rid = 0
        self._slot_rid = np.full(H, -1, np.int64)
        # long-prompt admission accounting (EngineConfig.long_prompt)
        self.prompts_rejected = 0
        self.prompts_truncated = 0
        # notified with the dropped Problem on every rejection
        self.on_prompt_rejected: Optional[Callable[[Problem], None]] = None
        # streamed in-flight weight broadcast: shadow param buffer filled
        # chunk by chunk between decode steps
        self._wstream: Optional[Dict[str, Any]] = None
        # integrity gate accounting: damaged chunks rejected by the
        # per-chunk checksum, assembled streams rejected by the digest
        self.wchunks_rejected = 0
        self.wstreams_torn = 0
        self.last_stream_installed = True

    def _check_params(self, params) -> None:
        for leaf in tree_flatten(params)[0]:
            dev = leaf.to_local().device if is_distributed(leaf) \
                else leaf.device
            if dev != self.device:
                raise ValueError(f"params on {dev}, engine on "
                                 f"{self.device}")

    # ----- device placement (real mesh) ---------------------------------
    def _ctx(self):
        """The sharding context of every model call: none without a mesh,
        so the single-device engine is untouched."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.shardctx import sharding_context
        return sharding_context(self.mesh, self.rules)

    def _place_leaves(self, leaves, placements) -> List[Any]:
        """Leaves onto this engine's mesh: one already there in its
        placement is kept; one on another mesh is gathered whole (a
        collective over its own mesh, which every rank of that mesh joins)
        and each rank of the engine's mesh keeps its own block of the
        copy, with no further traffic; a whole tensor is scattered from
        the mesh's first rank. A rank outside the mesh keeps an empty
        block."""
        from repro_torch.sharding import distribute
        out = []
        for x, pl in zip(leaves, placements):
            if not is_distributed(x):
                out.append(distribute(x, self.mesh, pl))
            elif (x.device_mesh == self.mesh
                    and tuple(x.placements) == tuple(pl)):
                out.append(x)
            else:
                out.append(distribute(full(x), self.mesh, pl,
                                      src_data_rank=None))
        return out

    def _place(self, params):
        leaves, treedef = tree_flatten(params)
        return tree_unflatten(treedef, self._place_leaves(
            leaves, self._pshard_leaves))

    def _place_cache(self, cache):
        """Slot-cache leaves split by `CACHE_LOGICAL` through the rules (a
        leaf without logical axes stays replicated: a plain tensor)."""
        from repro_torch.configs.base import CACHE_LOGICAL
        from repro_torch.sharding import (distribute, logical_to_spec,
                                          placements_for)
        out = {}
        for k, v in cache.items():
            if k not in CACHE_LOGICAL:
                out[k] = v
                continue
            pl = placements_for(logical_to_spec(
                CACHE_LOGICAL[k], v.shape, self.mesh, self.rules), self.mesh)
            out[k] = distribute(v, self.mesh, pl)
        return out

    def _lockstep(self, t: Optional[torch.Tensor], shape, dtype):
        """The mesh's first rank's `t` on every rank of the group, as numpy:
        one broadcast over the whole group (a rank outside the mesh passes
        None and receives)."""
        import torch.distributed as dist
        buf = (t.contiguous() if t is not None
               else torch.zeros(shape, dtype=dtype, device=self.device))
        dist.broadcast(buf, src=self._src)
        self.lockstep["broadcasts"] += 1
        self.lockstep["bytes"] += buf.numel() * buf.element_size()
        self.blocking_transfers += 1
        return buf.cpu().numpy()

    # ----- weights -----------------------------------------------------
    @torch.no_grad()
    def set_weights(self, params, version: int, recompute_kv: bool = False,
                    _placed: bool = False) -> None:
        """In-flight weight update: swap μ, keep the (stale) KV cache.
        recompute_kv=True reproduces the paper's §5.1 ablation (recompute
        the cache of in-progress sequences under the new weights). An
        atomic swap supersedes any weight stream in progress.

        On a mesh engine the swap is an executed transfer: the tree is
        placed on this engine's mesh and the measured seconds (with a
        device sync) land in `wexec_log`; `_placed=True` skips that when
        the buffers already are (the last chunk of a stream)."""
        if self.mesh is not None and not _placed:
            t0 = time.perf_counter()
            params = self._place(params)
            synchronize(self.device)
            self.wexec_log.append({
                "kind": "atomic", "version": int(version), "k": -1,
                "nbytes": tree_bytes(params),
                "seconds": time.perf_counter() - t0})
        self._check_params(params)
        self._wstream = None
        self.params = params
        self.version = version
        if recompute_kv and self._runs:
            with self._ctx():
                if self._paged:
                    # the scatter overwrites every position of every
                    # referenced page, which must not clobber a page other
                    # forks still read
                    self._unshare_all()
                    self._sync_tables()
                    _recompute_impl_paged(params, self.state, self._bt,
                                          self.cfg)
                else:
                    _recompute_impl(params, self.state, self.cfg)

    def begin_weight_stream(self, params, version: int, n_chunks: int = 8,
                            recompute_kv: bool = False,
                            expect_digest: Optional[int] = None,
                            chunk_leaves: Optional[List[List[Any]]] = None
                            ) -> List[int]:
        """Streamed in-flight broadcast: stage the new param tree into a
        shadow buffer chunk by chunk between decode steps via
        `stream_weight_chunk`; μ (and `self.version`) stay on the old
        weights until the final chunk lands, then pointer-swap, so
        per-token `weight_versions` stamps stay exact. A second `begin`
        abandons the unfinished shadow buffer. `expect_digest` arms the
        integrity gate: the assembled stream must reproduce it before the
        swap. `chunk_leaves[k]`, when given, holds the k-th span's leaves
        already placed on this engine's mesh (a `WeightBroadcaster`
        executor ran the transfer); installs take those buffers. Returns
        the per-chunk byte sizes."""
        if self.mesh is None:
            self._check_params(params)
        leaves, treedef = tree_flatten(params)
        spans = chunk_spans(leaves, n_chunks)
        sizes = span_bytes(leaves, spans)
        self._wstream = {
            "treedef": treedef, "leaves": leaves, "spans": spans,
            "sizes": sizes, "shadow": [None] * len(leaves), "next": 0,
            "version": version, "recompute": recompute_kv,
            "expect": expect_digest, "tokens": [],
            "chunk_leaves": chunk_leaves,
        }
        return sizes

    def stream_weight_chunk(self, token: Optional[int] = None) -> bool:
        """Install the next chunk into the shadow buffer; on the last
        chunk, assemble the tree and swap it in (returns True). No-op
        (False) when no stream is active. A chunk whose checksum `token`
        does not match this engine's own span table is rejected before it
        touches the shadow buffer (`wchunks_rejected`); a stream that is
        incomplete or fails the digest never installs (`wstreams_torn`)."""
        ws = self._wstream
        if ws is None:
            return False
        k = ws["next"]
        if token is not None and token != chunk_token(ws["version"], k,
                                                       ws["sizes"][k]):
            self.wchunks_rejected += 1
            return False
        lo, hi = ws["spans"][k]
        if ws["chunk_leaves"] is not None:
            # executor-placed span (k-indexed: a retransmit after a
            # rejected chunk takes the right span)
            ws["shadow"][lo:hi] = list(ws["chunk_leaves"][k])
        elif self.mesh is not None:
            # in-engine executed transfer of the span, measured
            t0 = time.perf_counter()
            placed = self._place_leaves(ws["leaves"][lo:hi],
                                        self._pshard_leaves[lo:hi])
            synchronize(self.device)
            self.wexec_log.append({
                "kind": "chunk", "version": int(ws["version"]), "k": k,
                "nbytes": ws["sizes"][k],
                "seconds": time.perf_counter() - t0})
            ws["shadow"][lo:hi] = placed
        else:
            ws["shadow"][lo:hi] = ws["leaves"][lo:hi]
        ws["tokens"].append(chunk_token(ws["version"], k, ws["sizes"][k]))
        ws["next"] += 1
        if ws["next"] < len(ws["spans"]):
            return False
        torn = any(x is None for x in ws["shadow"]) or (
            ws["expect"] is not None
            and stream_digest(ws["tokens"]) != ws["expect"])
        self._wstream = None
        if torn:
            self.wstreams_torn += 1
            self.last_stream_installed = False
            return True
        self.last_stream_installed = True
        self.set_weights(tree_unflatten(ws["treedef"], ws["shadow"]),
                         ws["version"], recompute_kv=ws["recompute"],
                         _placed=self.mesh is not None)
        return True

    @property
    def stream_active(self) -> bool:
        return self._wstream is not None

    # ----- crash semantics ----------------------------------------------
    def reset_slots(self) -> int:
        """Kill every in-flight sequence (engine-process crash semantics).
        All slots go inactive and their token/KV contents are abandoned
        (admission overwrites tokens and prefill rewrites every cache
        position a later decode step may read); any half-filled weight
        stream is dropped. Paged, every page reference (shared prefix pages
        drop one per holding slot) returns to the pool, and prompts deferred
        by page pressure are dropped with the slots (a salvage path calls
        `drain_deferred()` first). Returns the number of live slots
        killed."""
        n = int(self._host_active.sum())
        H = self.ec.n_slots
        self._host_active[:] = False
        self._host_ncached[:] = 0
        self._host_prompt_len[:] = 1
        self.problems = [None] * H
        self._wstream = None
        self._deferred.clear()
        if self._paged:
            for s in range(H):
                self.tables.release_row(s)
            assert self.allocator.live_pages == 0, "pages leaked on reset"
            self._bt_dirty = True
            self._sync_tables()
        if self._runs:
            st = self.state
            st["n_cached"].zero_()
            st["prompt_len"].fill_(1)
            st["active"].zero_()
        return n

    def drain_deferred(self) -> List[Problem]:
        """Hand back prompts parked by page-exhaustion deferral or
        preemption (the salvage path re-offers them to the pool)."""
        out = list(self._deferred)
        self._deferred.clear()
        return out

    def kill_slot(self, s: int) -> Optional[Problem]:
        """Kill ONE live slot without crashing the engine (the Server's
        quarantine path): the slot's rollout-in-progress is abandoned as in
        `reset_slots` (tokens and KV left for reuse; paged, its pages,
        shared prefix refs included, return to the pool) and its prompt is
        handed back so the caller can quarantine or requeue it. Returns None
        for an inactive slot."""
        s = int(s)
        if not self._host_active[s]:
            return None
        prob = self.problems[s]
        self._host_active[s] = False
        self._host_ncached[s] = 0
        self._host_prompt_len[s] = 1
        self.problems[s] = None
        if self._paged:
            self.tables.release_row(s)
            self._bt_dirty = True
            self._sync_tables()
        if self._runs:
            st = self.state
            st["n_cached"][s] = 0
            st["prompt_len"][s] = 1
            st["active"][s] = False
        return prob

    # ----- paged-cache machinery ----------------------------------------
    @property
    def free_pages(self) -> int:
        """Free pages in the pool (a large sentinel for the slot cache,
        whose admission is bounded by slots only)."""
        if not self._paged:
            return 1 << 30
        return self.allocator.free_pages

    def pages_needed(self, prompt_len: int) -> int:
        """Pages a prompt of `prompt_len` needs through admission and its
        first decode write (its footprint is capped by the ring length)."""
        if not self._paged:
            return 0
        return self.tables.blocks_for(
            min(max(int(prompt_len), 1), self._cache_len))

    def can_admit(self, prompt_len: int) -> bool:
        """Page-costed admission check (the router's gate): a free slot
        exists and the pool can back the prompt without evicting in-flight
        work. Slot engines only check slots."""
        if not (~self._host_active).any():
            return False
        return self.free_pages >= self.pages_needed(prompt_len)

    def _sync_tables(self) -> None:
        """Mirror the host block table to the device, once per change."""
        if self._paged and self._bt_dirty:
            if self._runs:
                self._bt.copy_(torch.from_numpy(self.tables.table))
                self.blocking_transfers += 1
            self._bt_dirty = False

    def _unshare_all(self) -> None:
        """Break every copy-on-write share: afterwards each live page is
        referenced by one table entry. No device copy: recompute_kv's
        scatter overwrites every position of every referenced page."""
        tb, alloc = self.tables, self.allocator
        for s in range(self.ec.n_slots):
            for j in range(tb.n_blocks):
                p = int(tb.table[s, j])
                if p and alloc.refcount[p] > 1:
                    q = alloc.alloc()
                    alloc.refcount[p] -= 1
                    tb.table[s, j] = q
                    self._bt_dirty = True

    def _evict_one(self, requester: int) -> bool:
        """Preempt the least-progressed active slot (ties: higher index) to
        free its pages; its prompt re-enters through `_deferred` at the
        front. Returns False when no victim exists."""
        victims = [s for s in np.where(self._host_active)[0]
                   if s != requester]
        if not victims:
            return False
        progress = {s: int(self._host_ncached[s] - self._host_prompt_len[s])
                    for s in victims}
        victim = max(victims, key=lambda s: (-progress[s], s))
        self.tables.release_row(victim)
        self._bt_dirty = True
        self._host_active[victim] = False
        prob = self.problems[victim]
        self.problems[victim] = None
        if prob is not None:
            self._deferred.appendleft(prob)
        self.slots_preempted += 1
        # the step reads `active` from the device state: push the kill
        if self._runs:
            self.state["active"][int(victim)] = False
        return True

    def _ensure_block(self, s: int, j: int,
                      copies: List[Tuple[int, int]]) -> None:
        """Allocate or copy-on-write block j of slot s, evicting under page
        pressure. Terminates: n_pages-1 >= n_blocks (checked at init) and
        the requester holds < n_blocks pages when it needs one, so once
        every other slot is evicted a free page exists."""
        while True:
            before = int(self.tables.table[s, j])
            try:
                pair = self.tables.ensure_writable(s, j)
            except OutOfPages:
                if not self._evict_one(s):
                    raise
                continue
            if pair is not None:
                copies.append(pair)
                self.pages_copied += 1
            if int(self.tables.table[s, j]) != before:
                self._bt_dirty = True
            return

    def _prepare_pages_for_step(self) -> int:
        """Before every decode step: make each active slot's write block
        (ring position n_cached mod CL) exclusively owned (lazy alloc at
        block entry, copy-on-write at a fork's divergence block) and make
        the copies on the device. The step relies on it: no write ever
        lands on a page with refcount > 1. Returns the pages copied."""
        ps = self.allocator.page_size
        cl = self._cache_len
        copies: List[Tuple[int, int]] = []
        for s in np.where(self._host_active)[0]:
            if not self._host_active[s]:
                continue  # evicted by an earlier slot's allocation
            j = (int(self._host_ncached[s]) % cl) // ps
            self._ensure_block(int(s), j, copies)
        if copies and self._runs:
            src = torch.tensor([c[0] for c in copies], device=self.device)
            dst = torch.tensor([c[1] for c in copies], device=self.device)
            self.blocking_transfers += 2
            for k in _attention_leaves(self.state["cache"]):
                pool = self.state["cache"][k]
                pool[:, dst] = pool[:, src]
        self._sync_tables()
        return len(copies)

    def _copy_fork_rows(self, forks: List[Tuple[int, int]]) -> int:
        """Recurrent SSM state is per slot, not paged: each (fork, leader)
        fork takes a copy of the leader's post-prefill conv and ssd rows
        (a hybrid or interleaved config's, every Mamba2 layer's;
        attention-only configs have none), a layer at a time: the gathered
        rows of every layer at once would hold (layers x forks) SSD rows,
        16.9 GB for granite-4.0-h-micro's 224 forks of a first refill.
        Returns the slot rows copied."""
        if not self._runs or "conv" not in self.state["cache"]:
            return 0
        cache = self.state["cache"]
        dst = torch.tensor([f for f, _ in forks], device=self.device)
        src = torch.tensor([ldr for _, ldr in forks], device=self.device)
        self.blocking_transfers += 2
        for k in ("conv", "ssd"):
            for layer in cache[k]:
                layer[dst] = layer[src]
        return len(forks)

    def _release_slot_pages(self, s: int) -> None:
        """Rollout finished: drop the slot's page references (shared prefix
        pages live on until the last fork finishes) and point its row at
        the trash page, which takes the inactive row's stale writes."""
        self.tables.release_row(int(s))
        self._bt_dirty = True

    # ----- admission ----------------------------------------------------
    def _next_prompt(self, rejects_left: int
                     ) -> Tuple[Optional[Problem], int, int]:
        """Pull one admissible prompt: (problem or None, prompt length,
        rejections left in this refill's budget). A rejected prompt
        re-offers the slot at once; the budget bounds the spin against a
        source that yields nothing but overlong prompts."""
        T = self.ec.max_len
        while rejects_left > 0:
            prob = (self._deferred.popleft() if self._deferred
                    else self.prompt_source())
            if prob is None:
                return None, 0, rejects_left
            pl = len(prob.prompt_ids)
            if pl <= T - 2:
                return prob, pl, rejects_left
            # no room for even one sampled token + EOS: clip (opt-in) or
            # reject and count — never silently truncate
            if self.ec.long_prompt == "truncate":
                self.prompts_truncated += 1
                return prob, T - 2, rejects_left
            self.prompts_rejected += 1
            if self.on_prompt_rejected is not None:
                self.on_prompt_rejected(prob)
            rejects_left -= 1
        return None, 0, 0

    @torch.no_grad()
    def refill(self, now: float = 0.0) -> int:
        """Fill inactive slots with fresh prompts. The prompt source may
        return None to decline; those slots stay inactive. Returns the
        number admitted. Admission scatters the new rows into the device
        state, then chunked prefill writes the prompts' K/V into the cache
        in ceil((P-1)/chunk) batched forwards (prefill_chunk=0: the legacy
        token-at-a-time loop).

        Paged: a prompt enters only when the pool can back its blocks
        (else it parks in `_deferred`, taken first next time, and the
        engine stops pulling); identical prompts admitted together form a
        GRPO prefix-sharing group whose leader alone runs prefill (and
        alone counts prefill tokens and pages) while the rest fork its
        pages copy-on-write."""
        self.last_admit_prefill_tokens = 0
        self.last_admit_pages = 0
        with trace.span("engine.refill") as sp:
            if not (~self._host_active).any():
                return 0
            allocs0 = self.allocator.total_allocs if self._paged else 0
            with trace.span("engine.refill.admit") as adm:
                got = self._admit(now)
                if adm and got is not None:
                    adm.set(rids=self._slot_rid[got[0]].tolist())
            if got is None:
                return 0
            mask, new_plen, prefill_mask, forks = got
            if self.prefill_chunk_size:
                with trace.span("engine.refill.prefill") as pre:
                    chunks, rows = self._prefill(new_plen, mask,
                                                 prefill_mask)
                    if pre:
                        pre.set(chunks=chunks, rows=rows,
                                leaders=new_plen[prefill_mask].tolist())
            if forks:
                with trace.span("engine.refill.fork") as fk:
                    state_rows = self._fork(forks)
                    if fk:
                        fk.set(state_rows=state_rows)
            if self._paged:
                self.last_admit_pages = self.allocator.total_allocs - allocs0
            n = int(mask.sum())
            if sp:
                sp.set(admitted=n)
        return n

    def _admit(self, now: float):
        """Pull prompts into the free slots and scatter them into the
        device state; None when none entered, else (admitted mask, prompt
        lengths, rows that run prefill, (fork, leader) pairs)."""
        free = np.where(~self._host_active)[0]
        H, T = self.ec.n_slots, self.ec.max_len
        new_tokens = np.full((H, T), self.ec.pad_id, np.int64)
        new_plen = np.zeros(H, np.int64)
        mask = np.zeros(H, bool)
        chunk = self.prefill_chunk_size
        # prefix sharing needs the chunked path: forks resume at n_cached =
        # P-1, which the legacy token-forcing loop never reaches
        share = self._paged and chunk > 0 and self.ec.prefix_sharing
        leaders: Dict[Tuple[int, ...], int] = {}
        prefill_mask = np.zeros(H, bool)   # rows that run prefill
        forks: List[Tuple[int, int]] = []  # (fork slot, leader slot)
        rejects_left = _MAX_REJECTS_PER_REFILL
        for s in free:
            prob, pl, rejects_left = self._next_prompt(rejects_left)
            if rejects_left <= 0:
                break
            if prob is None:
                continue
            key = tuple(prob.prompt_ids[:pl]) if share else None
            if share and key in leaders:
                forks.append((int(s), leaders[key]))
            elif self._paged:
                if self.allocator.free_pages < self.pages_needed(pl):
                    # page-costed admission: park the prompt and stop
                    # pulling; pages free up as rollouts finish
                    self._deferred.appendleft(prob)
                    break
                need = (self.tables.blocks_for(
                    min(max(pl - 1, 0), self._cache_len)) if chunk else 0)
                if need:
                    self.tables.alloc_prefix(int(s), need)
                    self._bt_dirty = True
                if share:
                    leaders[key] = int(s)
                prefill_mask[s] = True
            else:
                prefill_mask[s] = True
            new_tokens[s, :pl] = prob.prompt_ids[:pl]
            new_plen[s] = pl
            mask[s] = True
            self.problems[s] = prob
            self.ver_buf[s] = 0
            self.started_at[s] = now
            self._slot_rid[s] = self.next_rid
            self.next_rid += 1
        if not mask.any():
            return None
        # chunked path: decode resumes at the LAST prompt token
        # (n_cached = P-1); the legacy path starts at 0 and forces the
        # prompt token by token
        target_nc = np.maximum(new_plen - 1, 0) if chunk else np.zeros(H, np.int64)
        dev = self.device
        if self._runs:
            with self._ctx():
                _admit_impl(self.state, torch.from_numpy(new_tokens).to(dev),
                            torch.from_numpy(new_plen).to(dev),
                            torch.from_numpy(target_nc).to(dev),
                            torch.from_numpy(mask).to(dev))
            self.blocking_transfers += 4
        self._host_active[mask] = True
        self._host_prompt_len[mask] = new_plen[mask]
        self._host_ncached[mask] = target_nc[mask]
        self._sync_tables()
        return mask, new_plen, prefill_mask, forks

    def _prefill(self, new_plen: np.ndarray, mask: np.ndarray,
                 prefill_mask: np.ndarray) -> Tuple[int, int]:
        """Chunked prefill of the admitted rows that need it (forks never
        prefill: their cache is the leader's prefix). The chunks run on a
        compact batch of the rows this refill admitted (`mask`): their
        tokens, prompt lengths and, paged, block-table rows; the
        slot-indexed cache leaves (the slot cache's attention leaves, the
        SSM's conv and ssd) are gathered before the first chunk and written
        back after the last, while page pools take the writes in place, in
        pages the prefilled rows own. A fork takes part in the compute and
        writes nothing: the card's GEMMs choose their kernels by row count,
        so a paged engine that shares a GRPO group's prefix must run the
        batch of a slot engine that prefills every copy to match it bit for
        bit. Every slot takes part instead where a row does not stand alone:
        an MoE layer's capacity is shared by every row of a call, and a mesh
        engine's slot cache is split on its batch axis. Returns (chunks run,
        rows in each chunk call)."""
        chunk = self.prefill_chunk_size
        n_pre = int(new_plen[prefill_mask].max(initial=1)) - 1
        # where every slot was admitted, the compact batch is the slots as
        # they are, with nothing to gather
        every = (self.cfg.n_experts > 0 or self.mesh is not None
                 or bool(mask.all()))
        n_rows = self.ec.n_slots if every else int(mask.sum())
        offsets = range(0, n_pre, chunk)
        if self._runs:
            st = self.state
            cache, bt = st["cache"], self._bt
            slot_leaves: List[str] = []
            if every:
                tokens, plen = st["tokens"], st["prompt_len"]
                admit = torch.from_numpy(prefill_mask).to(self.device)
            else:
                # one copy: the admitted rows, and which of them prefill
                sel = np.nonzero(mask)[0]
                idx = torch.from_numpy(np.stack([sel, prefill_mask[sel]])).to(
                    self.device)
                rows, admit = idx[0], idx[1].bool()
                tokens, plen = st["tokens"][rows], st["prompt_len"][rows]
                slot_leaves = [k for k in cache if not (
                    self._paged and k in _PAGED_LEAVES)]
                cache = dict(cache)
                for k in slot_leaves:
                    cache[k] = cache[k][:, rows]
                if self._paged:
                    bt = bt[rows]
            self.blocking_transfers += 1
            with self._ctx():
                for off in offsets:
                    M.prefill_chunk(self.params, tokens, plen, off, admit,
                                    cache, self.cfg, chunk=chunk,
                                    block_tables=bt)
            for k in slot_leaves:
                st["cache"][k].index_copy_(1, rows, cache[k])
        self.prefill_invocations += len(offsets)
        self.prefill_row_tokens += len(offsets) * n_rows * chunk
        self.last_admit_prefill_tokens = int(
            np.maximum(new_plen[prefill_mask] - 1, 0).sum())
        self.prefill_tokens += self.last_admit_prefill_tokens
        self.prompt_prefills += int(prefill_mask.sum())
        return len(offsets), n_rows

    def _fork(self, forks: List[Tuple[int, int]]) -> int:
        """Each (fork, leader) pair shares the leader's prefix pages
        copy-on-write (and takes a copy of its recurrent rows). Returns
        the recurrent slot rows copied."""
        for f, ldr in forks:
            self.tables.fork_row(f, ldr)
        self._bt_dirty = True
        self._sync_tables()
        self.prefix_forks += len(forks)
        return self._copy_fork_rows(forks)

    @property
    def n_active(self) -> int:
        return int(self._host_active.sum())

    # ----- stepping -----------------------------------------------------
    @torch.no_grad()
    def step(self, task: Optional[MathTask] = None,
             now: float = 0.0) -> List[Rollout]:
        """Generate one token on every active slot; returns the rollouts
        that finished this step. Its spans tile it in order: the pages
        made ready, the device step enqueued, the wait for its `finished`
        mask, and the host's bookkeeping with the finished rows' fetch."""
        with trace.span("engine.step", version=self.version) as sp:
            with trace.span("engine.step.pages") as pg:
                if self._paged:
                    # every active slot's next write lands on an
                    # exclusively owned page (may preempt a slot, which
                    # deactivates it before the mirrors are copied)
                    copies = self._prepare_pages_for_step()
                    if pg:
                        pg.set(copies=copies)
            with trace.span("engine.step.enqueue"):
                prev_active = self._host_active.copy()
                prev_ncached = self._host_ncached.copy()
                H, T = self.ec.n_slots, self.ec.max_len
                finished_t = None
                if self._runs:
                    with self._ctx():
                        finished_t = _engine_step(
                            self.params, self.state, self.cfg, self.ec,
                            self.generator, self._bt)
            with trace.span("engine.step.wait"):
                # the step's one device sync (on a mesh, the first rank's
                # mask)
                if self.mesh is None:
                    finished = finished_t.cpu().numpy()
                    self.blocking_transfers += 1
                else:
                    finished = self._lockstep(
                        None if finished_t is None else finished_t.long(),
                        (H,), torch.long).astype(bool)
            with trace.span("engine.step.finish") as fin:
                rows_active = int(prev_active.sum())
                if sp:
                    sp.set(rows=rows_active)
                done = self._finish_step(task, now, prev_active,
                                         prev_ncached, finished,
                                         rows_active)
                if fin:
                    fin.set(rids=[r.rid for r in done])
        return done

    def _finish_step(self, task, now, prev_active, prev_ncached, finished,
                     rows_active) -> List[Rollout]:
        """The host's side of a decode step: version stamps, the mirrors,
        and the finished rows fetched into `Rollout`s."""
        # record the weight version of tokens written this step — only
        # tokens actually *sampled* under μ; prompt-forced tokens keep 0
        nxt = prev_ncached + 1
        wrote = (prev_active & (nxt < self.ec.max_len)
                 & (nxt >= self._host_prompt_len))
        self.ver_buf[wrote, nxt[wrote]] = self.version
        self.tokens_generated += rows_active
        # advance host mirrors (the device did n_cached+1 on active slots)
        self._host_ncached[prev_active] += 1
        self._host_active[finished] = False

        done: List[Rollout] = []
        if finished.any():
            rows = np.where(finished)[0]
            if self.mesh is None:
                rows_t = torch.from_numpy(rows).to(self.device)
                tokens = self.state["tokens"][rows_t].cpu().numpy().astype(
                    np.int32)
                lp = self.state["lp"][rows_t].cpu().numpy()
                self.blocking_transfers += 3
            else:
                tokens, lp = self._finished_rows(rows)
            for i, s in enumerate(rows):
                if self._paged:
                    self._release_slot_pages(int(s))
                L = min(int(self._host_ncached[s]) + 1, self.ec.max_len)
                prob = self.problems[s]
                pl = int(self._host_prompt_len[s])
                completion = tokens[i, pl:L]
                reward = 0.0
                if task is not None and prob is not None:
                    reward = task.reward(prob, completion,
                                         self.ec.max_len - pl)
                done.append(Rollout(
                    tokens=tokens[i, :L].copy(),
                    prompt_len=pl,
                    behavior_logprobs=lp[i, :L].copy(),
                    reward=reward,
                    weight_versions=self.ver_buf[s, :L].copy(),
                    finished_at=now,
                    prompt_key=(hash(tuple(prob.prompt_ids)) & 0x7FFFFFFF
                                if prob is not None else 0),
                    slot=int(s),
                    truncated=bool(tokens[i, L - 1] != self.ec.eos_id),
                    rid=int(self._slot_rid[s]),
                ))
        return done

    def _finished_rows(self, rows: np.ndarray):
        """(tokens int32, logprobs float32) of the finished `rows`, the
        mesh's first rank's, on every rank: one broadcast of both, the
        tokens and the float32 logprobs' bits side by side in int64."""
        packed = None
        if self._runs:
            rows_t = torch.from_numpy(rows).to(self.device)
            self.blocking_transfers += 1
            lp_bits = self.state["lp"][rows_t].view(torch.int32).long()
            packed = torch.cat([self.state["tokens"][rows_t], lp_bits], 1)
        T = self.ec.max_len
        out = self._lockstep(packed, (len(rows), 2 * T), torch.long)
        lp = out[:, T:].astype(np.int32).view(np.float32)
        return out[:, :T].astype(np.int32), lp

    def oldest_inflight_version(self) -> Optional[int]:
        """Smallest weight-version stamp among sampled tokens of in-flight
        (active, past-prompt) slots. None when nothing sampled is in
        flight."""
        oldest: Optional[int] = None
        for s in np.where(self._host_active)[0]:
            pl = int(self._host_prompt_len[s])
            nc = int(self._host_ncached[s])
            if nc + 1 <= pl:       # still in prompt: nothing sampled yet
                continue
            v = int(self.ver_buf[s, pl:min(nc + 1, self.ec.max_len)].min())
            oldest = v if oldest is None else min(oldest, v)
        return oldest
