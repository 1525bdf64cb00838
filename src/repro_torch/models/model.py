"""The decoder LM of the port: one definition for the dense GQA decoder,
the attention-free Mamba2 (SSM) stack, the Hymba hybrid (attention and SSM
heads in parallel in every layer), routed experts (MoE), DeepSeek-V3's
latent attention (MLA) with its leading dense layers and multi-token
prediction (MTP) head, and the multimodal prefix of the vision and audio
configs. Parameters, full-sequence forward, one-token decode and chunked
prefill against the slot cache or the paged pool.

Parameters are a nested dict in the JAX package's layout: stacked
`(count, ...)` leaves under `groups[i]`, one group per `(kind, count)` of
`layer_groups`, so a tree converts leaf for leaf between the two packages
(`repro_torch.convert`). The JAX package scans over each group's layers;
here a Python loop walks per-layer views of the stacked leaves. Decode and
prefill update the cache tensors in place: attention K/V, and the SSM's
conv and SSD state, or MLA's latent `c_kv` and `k_rope`. The
full-sequence forward is also the training forward: packed batches
(`segment_ids`), the fused lm-head loss (`loss_targets` with
`cfg.fused_loss`), the MoE load-balance loss
(`aux_loss`) and activation checkpointing (`cfg.remat`). The SSM branch
ignores `segment_ids`, as the JAX package's does: in a packed batch its
state runs on from one rollout into the next.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# `checkpoint` imports torch._dynamo at its first call, and that import
# leaves the frames of the stack it ran on in a reference cycle (torch.fx's
# `wrap` keeps its own frame, and a frame keeps its callers): whatever the
# first remat step's callers held, a Trainer or a PipelineRL, would live
# until the cyclic garbage collector runs. Imported here, the cycle holds
# only the import's frames.
import torch._dynamo  # noqa: E402,F401

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import init_leaf, rms_norm, swiglu

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def layer_groups(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(ffn kind, n_layers)], kind in {dense, moe, none}: the leading dense
    layers of an MoE config, then its MoE layers; "none" for d_ff == 0 (the
    Mamba2 block alone, no norm2 and no FFN)."""
    if cfg.n_experts:
        if cfg.n_dense_layers:
            return [("dense", cfg.n_dense_layers),
                    ("moe", cfg.n_layers - cfg.n_dense_layers)]
        return [("moe", cfg.n_layers)]
    if cfg.d_ff == 0:
        return [("none", cfg.n_layers)]
    return [("dense", cfg.n_layers)]


def _attention_shapes(cfg: ModelConfig, count: int) -> Dict[str, Any]:
    d, dt = cfg.d_model, cfg.dtype
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    if cfg.use_mla:
        qr, r = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {
            "wq_a": ((count, d, qr), dt, 0.02),
            "q_norm": ((count, qr), dt, -1.0),
            "wq_b": ((count, qr, H, nope + rope), dt, 0.02),
            "wkv_a": ((count, d, r + rope), dt, 0.02),
            "kv_norm": ((count, r), dt, -1.0),
            "wk_b": ((count, r, H, nope), dt, 0.02),
            "wv_b": ((count, r, H, vd), dt, 0.02),
            "wo": ((count, H, vd, d), dt, out_scale),
        }
    a = {
        "wq": ((count, d, H, Dh), dt, 0.02),
        "wk": ((count, d, KV, Dh), dt, 0.02),
        "wv": ((count, d, KV, Dh), dt, 0.02),
        "wo": ((count, H, Dh, d), dt, out_scale),
    }
    if cfg.use_qk_norm:
        a["qn"] = ((count, Dh), dt, -1.0)
        a["kn"] = ((count, Dh), dt, -1.0)
    return a


def _group_shapes(cfg: ModelConfig, kind: str, count: int) -> Dict[str, Any]:
    d, dt = cfg.d_model, cfg.dtype
    g: Dict[str, Any] = {"norm1": ((count, d), dt, -1.0)}
    if cfg.has_attention:
        g["attn"] = _attention_shapes(cfg, count)
    if cfg.has_ssm:
        g["ssm"] = ssm_mod.ssm_shapes(cfg, count)
    if cfg.arch_type == "hybrid":
        # Hymba: per-branch output norms, fused by averaging
        g["hyb_norm_a"] = ((count, d), dt, -1.0)
        g["hyb_norm_s"] = ((count, d), dt, -1.0)
    if kind == "dense":
        ff = cfg.dense_d_ff if (cfg.n_experts and cfg.dense_d_ff) else cfg.d_ff
        out_scale = 0.02 / math.sqrt(2 * max(count, 1))
        g["norm2"] = ((count, d), dt, -1.0)
        g["ffn"] = {"gate": ((count, d, ff), dt, 0.02),
                    "up": ((count, d, ff), dt, 0.02),
                    "down": ((count, ff, d), dt, out_scale)}
    elif kind == "moe":
        g["norm2"] = ((count, d), dt, -1.0)
        g["moe"] = moe_mod.moe_shapes(cfg, count)
    return g


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """(shape, dtype, init scale) of every leaf, in the JAX tree layout.
    Scale: stddev of the normal init; 0.0 zeros; -1.0 ones."""
    d, V, dt = cfg.d_model, cfg.vocab_size, cfg.dtype
    shapes: Dict[str, Any] = {
        "embed": ((V, d), dt, 0.02),
        "final_norm": ((d,), dt, -1.0),
        "groups": [_group_shapes(cfg, kind, count)
                   for kind, count in layer_groups(cfg)],
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, V), dt, 0.02)
    if cfg.use_value_head:
        shapes["value_head"] = ((d, 1), torch.float32, 0.0)
    if cfg.modality in ("vision", "audio"):
        # learned projector from the (stubbed) frontend embedding space
        shapes["mm_proj"] = ((d, d), dt, 0.02)
    if cfg.use_mtp:
        # DeepSeek-V3's MTP head: [norm(h_t); norm(emb_{t+1})] -> proj ->
        # one dense layer of width dense_d_ff
        shapes["mtp"] = {"proj": ((2 * d, d), dt, 0.02),
                         "norm_h": ((d,), dt, -1.0),
                         "norm_e": ((d,), dt, -1.0),
                         "layer": _group_shapes(cfg, "dense", 1)}
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights from `seed`, drawn by a generator on `device` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        shape, dtype, scale = node
        return init_leaf(shape, dtype, scale, gen, device)

    return build(param_shapes(cfg))


def layer_views(tree, n_layers: int) -> List[Any]:
    """All layers of a stacked `(L, ...)` subtree, as views made by one
    `torch.unbind` per leaf. Differentiated, each leaf then gets one
    stacked gradient, where `tree[l]` per layer would allocate a whole
    `(L, ...)` gradient for every layer."""
    if isinstance(tree, dict):
        subs = {k: layer_views(v, n_layers) for k, v in tree.items()}
        return [{k: sub[l] for k, sub in subs.items()}
                for l in range(n_layers)]
    return list(torch.unbind(tree))


def iter_layers(params: Params, cfg: ModelConfig
                ) -> Iterator[Tuple[int, str, Dict[str, Any]]]:
    """(layer index over the whole stack, ffn kind, that layer's views) for
    every layer, walking the groups in order."""
    l = 0
    for (kind, count), gp in zip(layer_groups(cfg), params["groups"]):
        for lp in layer_views(gp, count):
            yield l, kind, lp
            l += 1


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _mix(cfg: ModelConfig, lp, x, attn_fn, ssm_fn):
    """The token mixer of one layer on its normed input x: attention, the
    SSM, or (Hymba) both on the same x, each branch through its own RMS
    norm and the two averaged. attn_fn(attention params, x) and
    ssm_fn(SSM params, x) run the path's own primitive (and write its
    cache)."""
    if cfg.arch_type == "hybrid":
        a = attn_fn(lp["attn"], x)
        s = ssm_fn(lp["ssm"], x)
        return 0.5 * (rms_norm(a, lp["hyb_norm_a"], cfg.norm_eps)
                      + rms_norm(s, lp["hyb_norm_s"], cfg.norm_eps))
    if cfg.arch_type == "ssm":
        return ssm_fn(lp["ssm"], x)
    return attn_fn(lp["attn"], x)


def _ffn(cfg: ModelConfig, kind: str, h, lp):
    """The layer's second half by its kind. Returns (h, the MoE layer's
    aux loss, or None)."""
    if kind == "dense":
        x = rms_norm(h, lp["norm2"], cfg.norm_eps)
        f = lp["ffn"]
        return h + swiglu(x, f["gate"], f["up"], f["down"]), None
    if kind == "moe":
        x = rms_norm(h, lp["norm2"], cfg.norm_eps)
        mo, aux = moe_mod.moe_apply(lp["moe"], x, cfg)
        return h + mo, aux
    return h, None                  # the Mamba2 block has no FFN


def _fused_head_stats(params: Params, cfg: ModelConfig, hs, tgt):
    """The fused lm-head call: hs (N,D) rows against the head, targets (N,).
    Returns (lp, lse, ent). Tied embeddings pass `params["embed"]` in its
    own (V,D) layout (`transpose_head`), so no transposed copy is made."""
    if cfg.tie_embeddings:
        return kops.fused_logprob(hs, params["embed"], tgt,
                                  transpose_head=True)
    return kops.fused_logprob(hs, params["lm_head"], tgt,
                              transpose_head=False)


def _fused_loss_stats(params: Params, cfg: ModelConfig, h, loss_targets):
    """Per-token stats of the sampled tokens without (B,S,V) logits. h:
    (B,S,D) after the final norm; loss_targets: (B,S) with targets[t] =
    tokens[t+1]. Returns token_logprobs, lse and entropy, each (B,S)
    float32 and shifted so that entry t describes the distribution that
    scored token t (entry 0 is a zero pad), as `algo.token_logprobs`
    aligns them."""
    B, S, D = h.shape
    lp, lse, ent = _fused_head_stats(params, cfg, h.reshape(B * S, D),
                                     loss_targets.reshape(B * S))

    def shift(x):
        return F.pad(x.reshape(B, S)[:, :-1], (1, 0))

    return {"token_logprobs": shift(lp), "lse": shift(lse),
            "entropy": shift(ent)}


def _mtp_hidden(params: Params, cfg: ModelConfig, hidden, tokens,
                positions):
    """DeepSeek-V3's MTP trunk, the JAX package's `_mtp_hidden`
    (`models/model.py:304-316`): [norm(h_t); norm(emb_{t+1})] -> proj ->
    the one dense layer -> the final norm. hidden: (B,S,d) before the final
    norm, prefix rows stripped. Returns (B,S-1,d); row t carries the draft
    prediction of token t+2."""
    mp = params["mtp"]
    h_t = rms_norm(hidden[:, :-1], mp["norm_h"], cfg.norm_eps)
    e_next = rms_norm(params["embed"][tokens[:, 1:]], mp["norm_e"],
                      cfg.norm_eps)
    x = torch.cat([h_t, e_next], dim=-1) @ mp["proj"]
    (lp,) = layer_views(mp["layer"], 1)
    x, _, _ = _layer(cfg, "dense", x, lp, positions[:, 1:], None)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _mtp_outputs(params: Params, cfg: ModelConfig, hidden, tokens,
                 positions, fused: bool):
    """The MTP head's outputs: with the fused loss, its per-draft stats
    through the same fused lm-head call as the main loss (row t scores
    token t+2; the last row is a dead pad), `mtp_token_logprobs`,
    `mtp_lse` and `mtp_entropy`, each (B,S-1) float32, the JAX package's
    `_mtp_fused_stats`; else the (B,S-1,V) `mtp_logits`."""
    x = _mtp_hidden(params, cfg, hidden, tokens, positions)
    if not fused:
        return {"mtp_logits": x @ _head(params, cfg)}
    B, Sm1, D = x.shape
    tgt = torch.cat([tokens[:, 2:], tokens[:, -1:]], dim=1)
    lp, lse, ent = _fused_head_stats(params, cfg, x.reshape(B * Sm1, D),
                                     tgt.reshape(B * Sm1))
    return {"mtp_token_logprobs": lp.reshape(B, Sm1),
            "mtp_lse": lse.reshape(B, Sm1),
            "mtp_entropy": ent.reshape(B, Sm1)}


def _outputs(params: Params, cfg: ModelConfig, h, logits: bool,
             loss_targets=None, n_prefix: int = 0):
    """Final norm, then logits (or the fused loss stats) and values as the
    config asks, for the rows past the multimodal prefix."""
    h = rms_norm(h[:, n_prefix:], params["final_norm"], cfg.norm_eps)
    out: Dict[str, Any] = {}
    if cfg.fused_loss and loss_targets is not None:
        out.update(_fused_loss_stats(params, cfg, h, loss_targets))
    elif logits:
        out["logits"] = h @ _head(params, cfg)
    if cfg.use_value_head:
        out["values"] = (h.float() @ params["value_head"])[..., 0]
    return out


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _layer(cfg: ModelConfig, kind: str, h, lp, positions, segment_ids,
           want_cache: bool = False):
    """One layer; h: (B,S,d). Returns (h, aux or None, its cache leaves or
    None)."""
    cache: Dict[str, torch.Tensor] = {}

    def attn_fn(pa, x):
        if cfg.use_mla:
            a, (c_kv, k_rope) = attn.mla_forward(pa, x, positions, cfg,
                                                 segment_ids, return_kv=True)
            cache.update(c_kv=c_kv, k_rope=k_rope)
            return a
        a, (k, v) = attn.gqa_forward(pa, x, positions, cfg, segment_ids,
                                     return_kv=True)
        cache.update(k=k, v=v)
        return a

    def ssm_fn(ps, x):
        if not want_cache:
            return ssm_mod.ssm_forward(ps, x, cfg)
        s, (conv, ssd) = ssm_mod.ssm_forward(ps, x, cfg, return_state=True)
        cache.update(conv=conv, ssd=ssd)
        return s

    x = rms_norm(h, lp["norm1"], cfg.norm_eps)
    h = h + _mix(cfg, lp, x, attn_fn, ssm_fn)
    h, aux = _ffn(cfg, kind, h, lp)
    return h, aux, (cache if want_cache else None)


def forward(params: Params, tokens, positions, cfg: ModelConfig, *,
            segment_ids=None, prefix_embeds=None, loss_targets=None,
            return_cache: bool = False, logits: bool = True):
    """tokens, positions: (B,S) integer tensors; segment_ids: (B,S) of a
    packed batch, or None. Returns dict(logits?, values?, aux_loss,
    cache?).

    prefix_embeds: (B,P,d) embeddings of a stubbed frontend (the vision and
    audio configs), projected by `mm_proj` and put before the tokens at
    positions 0..P-1 (the tokens' positions shift by P; a packed batch's
    prefix takes segment 0). Their rows are stripped from the logits, the
    values and the fused stats, so every output but the cache matches
    `tokens`.

    loss_targets: optional (B,S) next-token targets (position t holds
    tokens[t+1]; the last column is dead). With `cfg.fused_loss` the head
    product and the cross-entropy fuse into `kernels.ops.fused_logprob`:
    no logits are made, and the output carries `token_logprobs`, `lse` and
    `entropy` instead. `logits=False` skips the (B,S,V) head product: eager
    PyTorch would compute it even when only the cache is wanted (the KV
    recompute), where XLA dropped it as dead code. `aux_loss` is the sum
    of the MoE layers' load-balance losses (float32; 0 without experts).
    With `cfg.remat` and grad mode on, each layer keeps only its input and
    recomputes the rest in the backward pass. return_cache gives the
    attention K/V (L,B,S,...) (MLA: the latent `c_kv` and `k_rope`) and
    the SSM's final conv and SSD state (L,B,...). With `cfg.use_mtp` the
    MTP head's outputs come too (`_mtp_outputs`, from the tokens' own
    positions), unless the call asks for neither logits nor the fused
    stats."""
    tok_positions = positions
    h = params["embed"][tokens]
    n_prefix = 0
    if prefix_embeds is not None:
        B, n_prefix = prefix_embeds.shape[:2]
        pe = prefix_embeds.to(cfg.dtype) @ params["mm_proj"]
        h = torch.cat([pe, h], dim=1)
        pre_pos = torch.arange(n_prefix, dtype=positions.dtype,
                               device=positions.device)
        positions = torch.cat([pre_pos[None].expand(B, n_prefix),
                               positions + n_prefix], dim=1)
        if segment_ids is not None:
            segment_ids = torch.cat([segment_ids.new_zeros((B, n_prefix)),
                                     segment_ids], dim=1)
    total_aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches: List[Dict[str, torch.Tensor]] = []
    remat = cfg.remat and torch.is_grad_enabled() and not return_cache
    for _, kind, lp in iter_layers(params, cfg):
        if remat:
            h, aux = checkpoint(
                lambda hh, lp=lp, kind=kind: _layer(
                    cfg, kind, hh, lp, positions, segment_ids)[:2],
                h, use_reentrant=False)
        else:
            h, aux, c = _layer(cfg, kind, h, lp, positions, segment_ids,
                               return_cache)
            if return_cache:
                caches.append(c)
        if aux is not None:
            total_aux = total_aux + aux
    out = _outputs(params, cfg, h, logits, loss_targets, n_prefix)
    fused = cfg.fused_loss and loss_targets is not None
    if cfg.use_mtp and (fused or logits):
        out.update(_mtp_outputs(params, cfg, h[:, n_prefix:], tokens,
                                tok_positions, fused))
    out["aux_loss"] = total_aux
    if return_cache:
        out["cache"] = {k: torch.stack([c[k] for c in caches])
                        for k in caches[0]}
    return out


# ---------------------------------------------------------------------------
# decode (one token against the cache)
# ---------------------------------------------------------------------------

def decode_step(params: Params, tokens, positions, cache, cache_index,
                cfg: ModelConfig, *, ring: Optional[bool] = None,
                block_tables=None, paged_kernel: bool = False):
    """tokens, positions: (B,1); cache: {"k", "v"} (L,B,CL,KV,Dh) (MLA:
    {"c_kv", "k_rope"} (L,B,CL,r|rope)), or page pools (L,NP,PS,...) when
    `block_tables` (B,NB) is given, and/or the SSM's {"conv", "ssd"}
    (L,B,...) (a hybrid has all four), updated in place; cache_index: (B,)
    write positions. `paged_kernel` reads the pool through the block table
    (`flash_decode_paged`) instead of gathering each slot's view (MLA
    decodes the gathered view in plain code either way). MoE layers route the B tokens together and
    drop their aux loss. Returns dict(logits (B,1,V), values (B,1)?,
    cache). ring=None takes the full ring exactly when the config is
    sliding-window (as the JAX package does); the engine passes ring=False
    and masks by count."""
    if ring is None:
        ring = (("k" in cache or "c_kv" in cache)
                and cfg.attention_variant == "sliding_window")
    h = params["embed"][tokens]
    for l, kind, lp in iter_layers(params, cfg):

        def attn_fn(pa, x, l=l):
            if cfg.use_mla:
                return attn.mla_decode(pa, x, positions, cache["c_kv"][l],
                                       cache["k_rope"][l], cache_index, cfg,
                                       ring, block_tables=block_tables)
            return attn.gqa_decode(pa, x, positions, cache["k"][l],
                                   cache["v"][l], cache_index, cfg, ring,
                                   block_tables=block_tables,
                                   paged_kernel=paged_kernel)

        def ssm_fn(ps, x, l=l):
            s, (conv, ssd) = ssm_mod.ssm_decode(ps, x, cache["conv"][l],
                                                cache["ssd"][l], cfg)
            cache["conv"][l].copy_(conv)
            cache["ssd"][l].copy_(ssd)
            return s

        x = rms_norm(h, lp["norm1"], cfg.norm_eps)
        h, _ = _ffn(cfg, kind, h + _mix(cfg, lp, x, attn_fn, ssm_fn), lp)
    out = _outputs(params, cfg, h, logits=True)
    out["cache"] = cache
    return out


# ---------------------------------------------------------------------------
# chunked prefill (batched prompt admission against the slot cache)
# ---------------------------------------------------------------------------

def _merge_state_(old, new, mask) -> None:
    """Write the rows of `new` where mask (B,) is True into `old`, in
    place; the other rows keep their state."""
    m = mask.reshape((-1,) + (1,) * (old.dim() - 1))
    old.copy_(torch.where(m, new.to(old.dtype), old))


def prefill_chunk(params: Params, tokens, prompt_len, offset: int, admit_mask,
                  cache, cfg: ModelConfig, *, chunk: int,
                  logits: bool = False, block_tables=None):
    """One chunk of chunked-prefill admission: prompt positions
    [offset, offset+chunk) of every slot through the whole stack, K/V and/or
    the SSM's conv and SSD state written into the cache in place. tokens:
    (B,T) slot token buffer; prompt_len: (B,); offset: host int, with
    offset + chunk <= T, offset % chunk == 0 and chunk | CL; admit_mask:
    (B,) bool, True for the slots admitted by this refill (the others take
    part in the compute, MoE routing and its capacity included, but their
    cache is untouched). Writes are also masked to positions
    < prompt_len - 1 of each row, so a wrapped ring never takes prompt
    garbage; the SSD recurrence takes the same mask as dt = 0 no-ops.
    Admission needs no logits (the first completion token is sampled by the
    decode step at n_cached = prompt_len - 1); `logits=True` also runs the
    last FFN and the head, to check the chunk's forward.
    With `block_tables` (B,NB) the attention leaves are page pools and the
    chunk must lie in one page. Returns dict(cache, logits (B,C,V)?,
    values (B,C)?)."""
    B = tokens.shape[0]
    toks = tokens[:, offset:offset + chunk]
    positions = (offset + torch.arange(chunk, device=tokens.device)
                 )[None].expand(B, chunk)
    pos_valid = positions < (prompt_len[:, None] - 1)            # (B,C)
    kv_write_mask = admit_mask[:, None] & pos_valid              # (B,C)
    tok_mask = pos_valid.float()
    h = params["embed"][toks]
    for l, kind, lp in iter_layers(params, cfg):

        def attn_fn(pa, x, l=l):
            if cfg.use_mla:
                return attn.mla_prefill_chunk(
                    pa, x, positions, cache["c_kv"][l], cache["k_rope"][l],
                    offset, kv_write_mask, cfg, block_tables=block_tables)
            return attn.gqa_prefill_chunk(pa, x, positions, cache["k"][l],
                                          cache["v"][l], offset,
                                          kv_write_mask, cfg,
                                          block_tables=block_tables)

        def ssm_fn(ps, x, l=l):
            conv, ssd = cache["conv"][l], cache["ssd"][l]
            s, (nconv, nssd) = ssm_mod.ssm_forward(
                ps, x, cfg, return_state=True, initial_state=(conv, ssd),
                token_mask=tok_mask)
            # only admitted rows may advance recurrent state
            _merge_state_(conv, nconv, admit_mask)
            _merge_state_(ssd, nssd, admit_mask)
            return s

        x = rms_norm(h, lp["norm1"], cfg.norm_eps)
        h = h + _mix(cfg, lp, x, attn_fn, ssm_fn)
        if logits or l + 1 < cfg.n_layers:  # else the last FFN feeds nothing
            h, _ = _ffn(cfg, kind, h, lp)
    out = _outputs(params, cfg, h, logits=True) if logits else {}
    out["cache"] = cache
    return out
