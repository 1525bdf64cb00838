"""The decoder LM of the port: one definition for the dense GQA decoder,
the attention-free Mamba2 (SSM) stack, the Hymba hybrid (attention and SSM
heads in parallel in every layer), Granite 4.0-H's interleaved layers (one
token mixer a layer, attention or Mamba2, by `layer_pattern`), routed
experts (MoE), DeepSeek-V3's latent attention (MLA) with its leading dense
layers and multi-token prediction (MTP) head, and the multimodal prefix of
the vision and audio configs. Parameters, full-sequence forward, one-token
decode and chunked prefill against the slot cache or the paged pool.

Parameters are a nested dict in the JAX package's layout: stacked
`(count, ...)` leaves under `groups[i]`, one group per `(kind, count)` of
`layer_groups`, so a tree converts leaf for leaf between the two packages
(`repro_torch.convert`). The JAX package scans over each group's layers;
here a Python loop walks per-layer views of the stacked leaves, in the
published order (`iter_layers`): an interleaved config stacks each
mixer's layers in a group of their own, and its caches stack the attention
leaves over its attention layers and the SSM leaves over its Mamba2
layers, each indexed by the layer's ordinal among its mixer's layers.
Decode and prefill update the cache tensors in place: attention K/V, and
the SSM's conv and SSD state, or MLA's latent `c_kv` and `k_rope`. The
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

from repro_torch.configs.base import CACHE_LOGICAL, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch import shardctx, trace
from repro_torch.models.layers import init_leaf, pad_before, rms_norm, swiglu
from repro_torch.shardctx import (constrain, current_mesh, is_distributed,
                                  merged_rules, redistribute)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def layer_groups(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(ffn kind, n_layers)], kind in {dense, moe, none}: the leading dense
    layers of an MoE config, then its MoE layers; "none" for d_ff == 0 (the
    Mamba2 block alone, no norm2 and no FFN). An interleaved config has one
    group of each mixer's layers (`group_mixers`)."""
    if cfg.layer_pattern:
        kind = "dense" if cfg.d_ff else "none"
        return [(kind, cfg.layer_pattern.count(m))
                for m in group_mixers(cfg)]
    if cfg.n_experts:
        if cfg.n_dense_layers:
            return [("dense", cfg.n_dense_layers),
                    ("moe", cfg.n_layers - cfg.n_dense_layers)]
        return [("moe", cfg.n_layers)]
    if cfg.d_ff == 0:
        return [("none", cfg.n_layers)]
    return [("dense", cfg.n_layers)]


def group_mixers(cfg: ModelConfig) -> str:
    """Each group's token mixer, one letter a group as
    `ModelConfig.mixers` names them: an interleaved config's groups in the
    order its pattern first names their mixers; every group of another
    config has the one mixer of all its layers."""
    if cfg.layer_pattern:
        return "".join(dict.fromkeys(cfg.layer_pattern))
    return cfg.mixers[:1] * len(layer_groups(cfg))


def _attention_shapes(cfg: ModelConfig, count: int) -> Dict[str, Any]:
    d, dt = cfg.d_model, cfg.dtype
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    Ll = ("layers",)
    if cfg.use_mla:
        qr, r = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        heads = Ll + ("p_lora", "p_heads", "p_head_dim")
        return {
            "wq_a": ((count, d, qr), dt, 0.02, Ll + ("p_embed", "p_lora")),
            "q_norm": ((count, qr), dt, -1.0, Ll + ("p_lora",)),
            "wq_b": ((count, qr, H, nope + rope), dt, 0.02, heads),
            "wkv_a": ((count, d, r + rope), dt, 0.02,
                      Ll + ("p_embed", "p_lora")),
            "kv_norm": ((count, r), dt, -1.0, Ll + ("p_lora",)),
            "wk_b": ((count, r, H, nope), dt, 0.02, heads),
            "wv_b": ((count, r, H, vd), dt, 0.02, heads),
            "wo": ((count, H, vd, d), dt, out_scale,
                   Ll + ("p_heads", "p_head_dim", "p_embed")),
        }
    a = {
        "wq": ((count, d, H, Dh), dt, 0.02,
               Ll + ("p_embed", "p_heads", "p_head_dim")),
        "wk": ((count, d, KV, Dh), dt, 0.02,
               Ll + ("p_embed", "p_kv_heads", "p_head_dim")),
        "wv": ((count, d, KV, Dh), dt, 0.02,
               Ll + ("p_embed", "p_kv_heads", "p_head_dim")),
        "wo": ((count, H, Dh, d), dt, out_scale,
               Ll + ("p_heads", "p_head_dim", "p_embed")),
    }
    if cfg.use_qk_norm:
        a["qn"] = ((count, Dh), dt, -1.0, Ll + ("p_head_dim",))
        a["kn"] = ((count, Dh), dt, -1.0, Ll + ("p_head_dim",))
    return a


def _group_shapes(cfg: ModelConfig, kind: str, count: int,
                  mixer: str) -> Dict[str, Any]:
    d, dt = cfg.d_model, cfg.dtype
    norm = ((count, d), dt, -1.0, ("layers", "p_embed"))
    g: Dict[str, Any] = {"norm1": norm}
    if mixer != "M":
        g["attn"] = _attention_shapes(cfg, count)
    if mixer != "A":
        g["ssm"] = ssm_mod.ssm_shapes(cfg, count)
    if mixer == "H":
        # Hymba: per-branch output norms, fused by averaging
        g["hyb_norm_a"] = norm
        g["hyb_norm_s"] = norm
    if kind == "dense":
        ff = cfg.dense_d_ff if (cfg.n_experts and cfg.dense_d_ff) else cfg.d_ff
        out_scale = 0.02 / math.sqrt(2 * max(count, 1))
        g["norm2"] = norm
        g["ffn"] = {"gate": ((count, d, ff), dt, 0.02,
                             ("layers", "p_embed", "p_mlp")),
                    "up": ((count, d, ff), dt, 0.02,
                           ("layers", "p_embed", "p_mlp")),
                    "down": ((count, ff, d), dt, out_scale,
                             ("layers", "p_mlp", "p_embed"))}
    elif kind == "moe":
        g["norm2"] = norm
        g["moe"] = moe_mod.moe_shapes(cfg, count)
    return g


def param_entries(cfg: ModelConfig) -> Dict[str, Any]:
    """(shape, dtype, init scale, logical axes) of every leaf, in the JAX
    tree layout: the JAX package's `ParamDef` fields. Scale: stddev of the
    normal init; 0.0 zeros; -1.0 ones. Logical axes name each dim for the
    sharding rules (`repro_torch.sharding`)."""
    d, V, dt = cfg.d_model, cfg.vocab_size, cfg.dtype
    shapes: Dict[str, Any] = {
        "embed": ((V, d), dt, 0.02, ("p_embed_vocab", "p_embed")),
        "final_norm": ((d,), dt, -1.0, ("p_embed",)),
        "groups": [_group_shapes(cfg, kind, count, mixer)
                   for (kind, count), mixer in zip(layer_groups(cfg),
                                                   group_mixers(cfg))],
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, V), dt, 0.02, ("p_embed", "p_vocab"))
    if cfg.use_value_head:
        shapes["value_head"] = ((d, 1), torch.float32, 0.0, ("p_embed", None))
    if cfg.modality in ("vision", "audio"):
        # learned projector from the (stubbed) frontend embedding space
        shapes["mm_proj"] = ((d, d), dt, 0.02, ("p_embed", None))
    if cfg.use_mtp:
        # DeepSeek-V3's MTP head: [norm(h_t); norm(emb_{t+1})] -> proj ->
        # one dense layer of width dense_d_ff
        shapes["mtp"] = {"proj": ((2 * d, d), dt, 0.02,
                                  ("p_embed", "p_embed")),
                         "norm_h": ((d,), dt, -1.0, ("p_embed",)),
                         "norm_e": ((d,), dt, -1.0, ("p_embed",)),
                         "layer": _group_shapes(cfg, "dense", 1, "A")}
    return shapes


def map_entries(fn, node):
    """Apply fn to every leaf entry of a `param_entries` tree."""
    if isinstance(node, dict):
        return {k: map_entries(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [map_entries(fn, v) for v in node]
    return fn(node)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """(shape, dtype, init scale) of every leaf, in the JAX tree layout."""
    return map_entries(lambda e: e[:3], param_entries(cfg))


def param_logical(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axis tuple of every leaf, in the JAX tree layout."""
    return map_entries(lambda e: e[3], param_entries(cfg))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights from `seed`, drawn by a generator on `device` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    return map_entries(
        lambda e: init_leaf(e[0], e[1], e[2], gen, device), param_entries(cfg))


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
                ) -> Iterator[Tuple[int, str, str, int, Dict[str, Any]]]:
    """(layer index over the whole stack, ffn kind, token mixer, the
    layer's index into its mixer's cache leaves, that layer's views) for
    every layer in the published order. Every layer of a config without a
    pattern has the one mixer, and its cache index is the layer's own; an
    interleaved config takes each layer from its mixer's group, and its
    cache index is its ordinal among that mixer's layers
    (`ModelConfig.mixer_ordinals`, resolved once a config)."""
    groups = layer_groups(cfg)
    if not cfg.layer_pattern:
        mixer, l = cfg.mixers[:1], 0
        for (kind, count), gp in zip(groups, params["groups"]):
            for lp in layer_views(gp, count):
                yield l, kind, mixer, l, lp
                l += 1
        return
    views = {m: layer_views(gp, count) for m, (_, count), gp in
             zip(group_mixers(cfg), groups, params["groups"])}
    for l, (m, i) in enumerate(cfg.mixer_ordinals):
        yield l, groups[0][0], m, i, views[m][i]


def _embed(params: Params, tokens) -> torch.Tensor:
    """The embedding rows of `tokens` (B,S). A distributed table is
    gathered whole and each rank reads its own tokens' rows, as GSPMD does
    for the JAX package's vocab-split table; the table's gradient is then
    a partial sum over the axes that split the tokens. DTensor's own rules
    for the lookup fail in torch 2.11 (the indexing form's backward, an
    accumulating `index_put` on a split index; `F.embedding`'s partial
    rows reduced later)."""
    table = params["embed"]
    if not is_distributed(table):
        return table[tokens]
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    mesh = table.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not is_distributed(tokens):
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    tok_axes = [i for i, p in enumerate(tokens.placements)
                if isinstance(p, Shard)]
    grad = [Partial() if i in tok_axes else Replicate()
            for i in range(mesh.ndim)]
    rows = redistribute(table, mesh, rep).to_local(
        grad_placements=grad)
    out = rows[tokens.to_local()]
    return DTensor.from_local(out, mesh, tokens.placements, run_check=False)


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _mix(cfg: ModelConfig, mixer: str, lp, x, attn_fn, ssm_fn):
    """The token mixer of one layer (`ModelConfig.mixers`) on its normed
    input x: attention, the SSM, or (Hymba) both on the same x, each branch
    through its own RMS norm and the two averaged. attn_fn(attention
    params, x) and ssm_fn(SSM params, x) run the path's own primitive (and
    write its cache)."""
    if mixer == "H":
        a = attn_fn(lp["attn"], x)
        s = ssm_fn(lp["ssm"], x)
        return 0.5 * (rms_norm(a, lp["hyb_norm_a"], cfg.norm_eps)
                      + rms_norm(s, lp["hyb_norm_s"], cfg.norm_eps))
    if mixer == "M":
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
    own (V,D) layout (`transpose_head`), so no transposed copy is made.
    Under a mesh (`shardctx.sharding_context`) the call is vocab-parallel
    over the mesh axis the head's vocab rule names
    (`kernels.sharded.fused_logprob_sharded`: each shard runs the fused
    kernels on its slice, three (N,) sums combine them), as the JAX
    package's `_fused_head_stats` routes it."""
    if cfg.tie_embeddings:
        head, transpose, logical = params["embed"], True, "p_embed_vocab"
    else:
        head, transpose, logical = params["lm_head"], False, "p_vocab"
    mesh = current_mesh()
    if mesh is not None:
        from repro_torch.kernels.sharded import fused_logprob_sharded
        return fused_logprob_sharded(hs, head, tgt, mesh=mesh,
                                     axis_name=merged_rules().get(logical),
                                     transpose_head=transpose)
    return kops.fused_logprob(hs, head, tgt, transpose_head=transpose)


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
        return pad_before(x.reshape(B, S)[:, :-1], 1, 1)

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
    e_next = rms_norm(_embed(params, tokens[:, 1:]), mp["norm_e"],
                      cfg.norm_eps)
    x = torch.cat([h_t, e_next], dim=-1) @ mp["proj"]
    (lp,) = layer_views(mp["layer"], 1)
    x, _, _ = _layer(cfg, "dense", "A", x, lp, positions[:, 1:], None)
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
        out["logits"] = constrain(h @ _head(params, cfg),
                                  ("batch", "seq", "vocab"))
    if cfg.use_value_head:
        out["values"] = (h.float() @ params["value_head"])[..., 0]
    return out


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _layer(cfg: ModelConfig, kind: str, mixer: str, h, lp, positions,
           segment_ids, want_cache: bool = False):
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
    h = constrain(h + _mix(cfg, mixer, lp, x, attn_fn, ssm_fn),
                  ("batch", "seq", "embed"))
    h, aux = _ffn(cfg, kind, h, lp)
    h = constrain(h, ("batch", "seq", "embed"))
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
    h = _embed(params, tokens)
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
    h = constrain(h, ("batch", "seq", "embed"))
    total_aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches: List[Dict[str, torch.Tensor]] = []
    remat = cfg.remat and torch.is_grad_enabled() and not return_cache
    # the recompute runs in the backward, on the autograd engine's thread
    # for CUDA tensors: it re-enters this call's sharding context
    sctx = shardctx.current()

    def layer_again(hh, lp, kind, mixer):
        with shardctx.resume(sctx):
            return _layer(cfg, kind, mixer, hh, lp, positions,
                          segment_ids)[:2]

    for _, kind, mixer, _, lp in iter_layers(params, cfg):
        if remat:
            h, aux = checkpoint(layer_again, h, lp, kind, mixer,
                                use_reentrant=False)
        else:
            h, aux, c = _layer(cfg, kind, mixer, h, lp, positions,
                               segment_ids, return_cache)
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
        # each leaf stacked over the layers that hold it
        keys = dict.fromkeys(k for c in caches for k in c)
        out["cache"] = {k: constrain(torch.stack([c[k] for c in caches
                                                  if k in c]),
                                     CACHE_LOGICAL[k])
                        for k in keys}
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
    h = constrain(_embed(params, tokens), ("batch", "seq", "embed"))
    for l, kind, mixer, i, lp in iter_layers(params, cfg):

        def attn_fn(pa, x, i=i):
            if cfg.use_mla:
                return attn.mla_decode(pa, x, positions, cache["c_kv"][i],
                                       cache["k_rope"][i], cache_index, cfg,
                                       ring, block_tables=block_tables)
            return attn.gqa_decode(pa, x, positions, cache["k"][i],
                                   cache["v"][i], cache_index, cfg, ring,
                                   block_tables=block_tables,
                                   paged_kernel=paged_kernel)

        def ssm_fn(ps, x, i=i, l=l):
            with trace.span("model.decode.ssm", layer=l):
                s, (conv, ssd) = ssm_mod.ssm_decode(ps, x, cache["conv"][i],
                                                    cache["ssd"][i], cfg)
                cache["conv"][i].copy_(conv)
                cache["ssd"][i].copy_(ssd)
            return s

        # the residual stream is held replicated after each half, as the
        # JAX package's layer scan holds its carry
        x = rms_norm(h, lp["norm1"], cfg.norm_eps)
        h = constrain(h + _mix(cfg, mixer, lp, x, attn_fn, ssm_fn),
                      ("batch", "seq", "embed"))
        h, _ = _ffn(cfg, kind, h, lp)
        h = constrain(h, ("batch", "seq", "embed"))
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
    [offset, offset+chunk) of each of the B rows through the whole stack,
    K/V and/or the SSM's conv and SSD state written into the cache in place.
    The rows are any batch of slots: the engine passes the rows it prefills
    alone, or every slot where rows are coupled (MoE). tokens: (B,T) token
    buffer; prompt_len: (B,); offset: host int, with offset + chunk <= T,
    offset % chunk == 0 and chunk | CL; admit_mask: (B,) bool, True for the
    rows to prefill (the others take part in the compute, MoE routing and
    its capacity included, but their cache is untouched). Writes are also
    masked to positions < prompt_len - 1 of each row, so a wrapped ring
    never takes prompt garbage; the SSD recurrence takes the same mask as
    dt = 0 no-ops.
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
    h = constrain(_embed(params, toks), ("batch", "seq", "embed"))
    for l, kind, mixer, i, lp in iter_layers(params, cfg):

        def attn_fn(pa, x, i=i):
            if cfg.use_mla:
                return attn.mla_prefill_chunk(
                    pa, x, positions, cache["c_kv"][i], cache["k_rope"][i],
                    offset, kv_write_mask, cfg, block_tables=block_tables)
            return attn.gqa_prefill_chunk(pa, x, positions, cache["k"][i],
                                          cache["v"][i], offset,
                                          kv_write_mask, cfg,
                                          block_tables=block_tables)

        def ssm_fn(ps, x, i=i):
            conv, ssd = cache["conv"][i], cache["ssd"][i]
            s, (nconv, nssd) = ssm_mod.ssm_forward(
                ps, x, cfg, return_state=True, initial_state=(conv, ssd),
                token_mask=tok_mask)
            # only admitted rows may advance recurrent state
            _merge_state_(conv, nconv, admit_mask)
            _merge_state_(ssd, nssd, admit_mask)
            return s

        x = rms_norm(h, lp["norm1"], cfg.norm_eps)
        h = constrain(h + _mix(cfg, mixer, lp, x, attn_fn, ssm_fn),
                      ("batch", "seq", "embed"))
        if logits or l + 1 < cfg.n_layers:  # else the last FFN feeds nothing
            h, _ = _ffn(cfg, kind, h, lp)
            h = constrain(h, ("batch", "seq", "embed"))
    out = _outputs(params, cfg, h, logits=True) if logits else {}
    out["cache"] = cache
    return out
