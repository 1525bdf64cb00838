"""The decoder LM of the port: the dense GQA decoder and the attention-free
Mamba2 (SSM) stack. Parameters, full-sequence forward, one-token decode and
chunked prefill against the slot cache or the paged pool.

Parameters are a nested dict in the JAX package's layout (stacked `(L, ...)`
leaves under `groups[0]`), so a tree converts leaf for leaf between the two
packages (`repro_torch.convert`). The JAX package scans over layers; here a
Python loop walks per-layer views of the stacked leaves. Decode and prefill
update the cache tensors in place: attention K/V, and the SSM's conv and
SSD state. The full-sequence forward is also the training forward: packed
batches (`segment_ids`), the fused lm-head loss (`loss_targets` with
`cfg.fused_loss`) and activation checkpointing (`cfg.remat`). The SSM
branch ignores `segment_ids`, as the JAX package's does: in a packed batch
its state runs on from one rollout into the next.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import init_leaf, rms_norm, swiglu

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """(shape, dtype, init scale) of every leaf, in the JAX tree layout.
    Scale: stddev of the normal init; 0.0 zeros; -1.0 ones."""
    if cfg.arch_type not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.arch_type!r}: only the dense GQA decoder and the Mamba2 "
            f"SSM are ported (ROADMAP.md queue A.6 ports the other "
            f"architectures)")
    L, d, V, dt = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype
    out_scale = 0.02 / math.sqrt(2 * L)
    group: Dict[str, Any] = {"norm1": ((L, d), dt, -1.0)}
    if cfg.has_attention:
        H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        a = {
            "wq": ((L, d, H, Dh), dt, 0.02),
            "wk": ((L, d, KV, Dh), dt, 0.02),
            "wv": ((L, d, KV, Dh), dt, 0.02),
            "wo": ((L, H, Dh, d), dt, out_scale),
        }
        if cfg.use_qk_norm:
            a["qn"] = ((L, Dh), dt, -1.0)
            a["kn"] = ((L, Dh), dt, -1.0)
        group["attn"] = a
    if cfg.has_ssm:
        group["ssm"] = ssm_mod.ssm_shapes(cfg, L)
    # the JAX package's layer kinds: "dense" (SwiGLU), or "none" for
    # d_ff == 0 (the Mamba2 block alone, no norm2 and no FFN)
    if cfg.d_ff:
        F = cfg.d_ff
        group["norm2"] = ((L, d), dt, -1.0)
        group["ffn"] = {"gate": ((L, d, F), dt, 0.02),
                        "up": ((L, d, F), dt, 0.02),
                        "down": ((L, F, d), dt, out_scale)}
    shapes: Dict[str, Any] = {
        "embed": ((V, d), dt, 0.02),
        "final_norm": ((d,), dt, -1.0),
        "groups": [group],
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, V), dt, 0.02)
    if cfg.use_value_head:
        shapes["value_head"] = ((d, 1), torch.float32, 0.0)
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


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _ffn(cfg: ModelConfig, h, lp):
    if "ffn" not in lp:         # the Mamba2 block has no FFN
        return h
    x = rms_norm(h, lp["norm2"], cfg.norm_eps)
    f = lp["ffn"]
    return h + swiglu(x, f["gate"], f["up"], f["down"])


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


def _outputs(params: Params, cfg: ModelConfig, h, logits: bool,
             loss_targets=None):
    """Final norm, then logits (or the fused loss stats) and values as the
    config asks."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
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

def _layer(cfg: ModelConfig, h, lp, positions, segment_ids,
           want_cache: bool = False):
    """One layer; h: (B,S,d). Returns (h, its cache leaves or None)."""
    x = rms_norm(h, lp["norm1"], cfg.norm_eps)
    if cfg.has_attention:
        a, (k, v) = attn.gqa_forward(lp["attn"], x, positions, cfg,
                                     segment_ids, return_kv=True)
        cache = {"k": k, "v": v}
    elif want_cache:
        a, (conv, ssd) = ssm_mod.ssm_forward(lp["ssm"], x, cfg,
                                             return_state=True)
        cache = {"conv": conv, "ssd": ssd}
    else:
        a = ssm_mod.ssm_forward(lp["ssm"], x, cfg)
    return _ffn(cfg, h + a, lp), (cache if want_cache else None)


def forward(params: Params, tokens, positions, cfg: ModelConfig, *,
            segment_ids=None, loss_targets=None, return_cache: bool = False,
            logits: bool = True):
    """tokens, positions: (B,S) integer tensors; segment_ids: (B,S) of a
    packed batch, or None. Returns dict(logits?, values?, cache?).

    loss_targets: optional (B,S) next-token targets (position t holds
    tokens[t+1]; the last column is dead). With `cfg.fused_loss` the head
    product and the cross-entropy fuse into `kernels.ops.fused_logprob`:
    no logits are made, and the output carries `token_logprobs`, `lse` and
    `entropy` instead. `logits=False` skips the (B,S,V) head product: eager
    PyTorch would compute it even when only the cache is wanted (the KV
    recompute), where XLA dropped it as dead code. With `cfg.remat` and
    grad mode on, each layer keeps only its input and recomputes the rest
    in the backward pass. return_cache gives the attention K/V (L,B,S,...)
    or the SSM's final conv and SSD state (L,B,...)."""
    h = params["embed"][tokens]
    caches: List[Dict[str, torch.Tensor]] = []
    remat = cfg.remat and torch.is_grad_enabled() and not return_cache
    for lp in layer_views(params["groups"][0], cfg.n_layers):
        if remat:
            h = checkpoint(lambda hh, lp=lp: _layer(cfg, hh, lp, positions,
                                                    segment_ids)[0],
                           h, use_reentrant=False)
            continue
        h, c = _layer(cfg, h, lp, positions, segment_ids, return_cache)
        if return_cache:
            caches.append(c)
    out = _outputs(params, cfg, h, logits, loss_targets)
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
    """tokens, positions: (B,1); cache: {"k", "v"} (L,B,CL,KV,Dh), or page
    pools (L,NP,PS,KV,Dh) when `block_tables` (B,NB) is given, or the SSM's
    {"conv", "ssd"} (L,B,...), updated in place; cache_index: (B,) write
    positions. `paged_kernel` reads the pool through the block table
    (`flash_decode_paged`) instead of gathering each slot's view. Returns
    dict(logits (B,1,V), values (B,1)?, cache). ring=None takes the full
    ring exactly when the config is sliding-window (as the JAX package
    does); the engine passes ring=False and masks by count."""
    if ring is None:
        ring = "k" in cache and cfg.attention_variant == "sliding_window"
    h = params["embed"][tokens]
    for l, lp in enumerate(layer_views(params["groups"][0], cfg.n_layers)):
        x = rms_norm(h, lp["norm1"], cfg.norm_eps)
        if cfg.has_attention:
            a = attn.gqa_decode(lp["attn"], x, positions, cache["k"][l],
                                cache["v"][l], cache_index, cfg, ring,
                                block_tables=block_tables,
                                paged_kernel=paged_kernel)
        else:
            a, (conv, ssd) = ssm_mod.ssm_decode(lp["ssm"], x, cache["conv"][l],
                                                cache["ssd"][l], cfg)
            cache["conv"][l].copy_(conv)
            cache["ssd"][l].copy_(ssd)
        h = _ffn(cfg, h + a, lp)
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
    [offset, offset+chunk) of every slot through the whole stack, K/V (or
    the SSM's conv and SSD state) written into the cache in place. tokens:
    (B,T) slot token buffer; prompt_len: (B,); offset: host int, with
    offset + chunk <= T, offset % chunk == 0 and chunk | CL; admit_mask:
    (B,) bool, True for the slots admitted by this refill (the others take
    part in the compute but their cache is untouched). Writes are also
    masked to positions < prompt_len - 1 of each row, so a wrapped ring
    never takes prompt garbage; the SSD recurrence takes the same mask as
    dt = 0 no-ops. Admission needs no logits (the first completion token
    is sampled by the decode step at n_cached = prompt_len - 1);
    `logits=True` also runs the last FFN and the head, to check the
    chunk's forward.
    With `block_tables` (B,NB) the cache leaves are page pools and the
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
    for l, lp in enumerate(layer_views(params["groups"][0], cfg.n_layers)):
        x = rms_norm(h, lp["norm1"], cfg.norm_eps)
        if cfg.has_attention:
            a = attn.gqa_prefill_chunk(lp["attn"], x, positions,
                                       cache["k"][l], cache["v"][l], offset,
                                       kv_write_mask, cfg,
                                       block_tables=block_tables)
        else:
            conv, ssd = cache["conv"][l], cache["ssd"][l]
            a, (nconv, nssd) = ssm_mod.ssm_forward(
                lp["ssm"], x, cfg, return_state=True,
                initial_state=(conv, ssd), token_mask=tok_mask)
            _merge_state_(conv, nconv, admit_mask)
            _merge_state_(ssd, nssd, admit_mask)
        if logits or l + 1 < cfg.n_layers:  # else the last FFN feeds nothing
            h = _ffn(cfg, h + a, lp)
    out = _outputs(params, cfg, h, logits=True) if logits else {}
    out["cache"] = cache
    return out
