"""Model config for the PyTorch port: the fields of the JAX package's
`ModelConfig` that the port reads, under the same names and with the same
defaults, with a torch dtype, and two fields of its own.

`arch_type` admits "dense" (the GQA decoder), "moe" (GQA or, with
`use_mla`, DeepSeek-V3's multi-head latent attention, with routed
experts), "ssm" (attention-free Mamba2 / SSD layers), "hybrid" (Hymba:
attention and SSM heads in parallel in every layer), "interleaved"
(Granite 4.0-H: one token mixer a layer, GQA or Mamba2, in the order
`layer_pattern` gives), "vlm" and "audio" (the dense decoder behind a
stubbed frontend's prefix embeddings).

The port's own fields, which the JAX package lacks and which every config
of its registry holds at their defaults: `layer_pattern` ("A" an
attention layer, "M" a Mamba2 layer, one letter a layer; only an
"interleaved" config has one) and `position_embedding` ("rope", or
"nope": GQA without a rotary embedding). Left out of the JAX fields:
`router_aux_coef` (the JAX package reads it nowhere; the Trainer weighs
the MoE loss by `RLConfig.aux_coef`) and `hybrid_parallel` (true exactly
when `arch_type` is "hybrid").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

# the port's own fields (module docstring), which the JAX package lacks
PORT_OWN_FIELDS = ("position_embedding", "layer_pattern")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | interleaved | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # attention options
    use_qk_norm: bool = False
    rope_theta: float = 10000.0
    position_embedding: str = "rope"  # rope | nope (no rotary embedding)
    attention_variant: str = "full"  # full | sliding_window (decode ring buffer)
    sliding_window: int = 8192
    # MLA (DeepSeek-V3 style multi-head latent attention)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0  # leading dense layers (DeepSeek-V3 uses 3)
    dense_d_ff: int = 0  # d_ff of those leading dense layers
    capacity_factor: float = 2.0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_n_groups: int = 1
    ssm_chunk: int = 64
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2
    # the "interleaved" layout: each layer's token mixer, "A" (attention)
    # or "M" (Mamba2), one letter a layer
    layer_pattern: str = ""
    # multimodal prefix (a stubbed frontend provides embeddings)
    modality: str = "text"  # text | vision | audio
    n_prefix_tokens: int = 0
    # DeepSeek multi-token prediction head
    use_mtp: bool = False
    mtp_depth: int = 1
    # numerics
    dtype: torch.dtype = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # value head for RL (paper Eq. 4 baseline)
    use_value_head: bool = True
    # activation checkpointing around each layer (training memory)
    remat: bool = False
    # fused linear-cross-entropy trainer loss: when the trainer passes loss
    # targets, `forward` skips the (B,S,V) logits and returns per-token
    # logprob/lse/entropy from `kernels.ops.fused_logprob`. Inference paths
    # (decode/prefill) are unaffected.
    fused_loss: bool = False
    source: str = ""

    def __post_init__(self):
        if (self.arch_type == "interleaved") != bool(self.layer_pattern) \
                or len(self.layer_pattern) not in (0, self.n_layers) \
                or set(self.layer_pattern) - set("AM"):
            raise ValueError(
                f"{self.name}: an interleaved config needs a layer_pattern "
                f"of {self.n_layers} letters A and M, and no other config "
                f"has one; got {self.layer_pattern!r}")
        if self.position_embedding not in ("rope", "nope"):
            raise ValueError(f"{self.name}: position_embedding "
                             f"{self.position_embedding!r}")

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid", "interleaved")

    @functools.cached_property
    def mixers(self) -> str:
        """Each layer's token mixer, one letter a layer: "A" attention, "M"
        Mamba2, "H" both in parallel (Hymba). Resolved once a config."""
        if self.layer_pattern:
            return self.layer_pattern
        return {"ssm": "M", "hybrid": "H"}.get(self.arch_type,
                                               "A") * self.n_layers

    @functools.cached_property
    def mixer_ordinals(self) -> Tuple[Tuple[str, int], ...]:
        """(token mixer, the layer's ordinal among that mixer's layers) of
        each layer: where an interleaved config's layer sits in its mixer's
        stacked parameters and caches. Resolved once a config."""
        seen: Dict[str, int] = {}
        out = []
        for m in self.mixers:
            out.append((m, seen.get(m, 0)))
            seen[m] = seen.get(m, 0) + 1
        return tuple(out)

    @property
    def n_attention_layers(self) -> int:
        """The layers with attention, which the attention cache stacks."""
        return sum(m != "M" for m in self.mixers)

    @property
    def n_ssm_layers(self) -> int:
        """The layers with a Mamba2 mixer, which the conv and SSD state
        stack."""
        return sum(m != "A" for m in self.mixers)

    @property
    def supports_long_decode(self) -> bool:
        """Every arch supports long_500k: SSM/hybrid natively (O(1) state);
        attention archs via the sliding-window ring-buffer cache."""
        return True

    def param_count(self, active_only: bool = False) -> int:
        """Parameters of the embedding, the head and the layers (the JAX
        package's analytic count: no MTP head, value head or projector);
        `active_only` counts the k routed experts a token uses."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for li, mixer in enumerate(self.mixers):
            n += 2 * d  # the two norms
            if mixer != "M" and self.use_mla:
                r, rope = self.kv_lora_rank, self.qk_rope_dim
                n += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + rope)
                n += d * (r + rope)
                n += r * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                n += self.n_heads * self.v_head_dim * d
            elif mixer != "M":
                n += 2 * d * self.n_heads * self.d_head  # q, o
                n += 2 * d * self.n_kv_heads * self.d_head  # k, v
            if mixer != "A":
                di = self.d_inner
                gn = 2 * self.ssm_n_groups * self.ssm_state
                n += d * (2 * di + gn + self.n_ssm_heads)
                n += self.d_conv * (di + gn) + 2 * self.n_ssm_heads + di * d
            if self.n_experts and li >= self.n_dense_layers:
                per_expert = 3 * d * self.moe_d_ff
                routed = (self.experts_per_token if active_only
                          else self.n_experts)
                n += d * self.n_experts + (routed + self.n_shared_experts
                                           ) * per_expert
            elif self.d_ff > 0:
                ff = (self.dense_d_ff if (self.n_experts and self.dense_d_ff)
                      else self.d_ff)
                n += 3 * d * ff
        return n


def effective_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer cache length actually allocated for a decode shape (0
    for an attention-free config)."""
    if not cfg.has_attention:
        return 0
    if cfg.use_mla:
        return seq_len  # the compressed latent cache: full length, no ring
    if cfg.attention_variant == "sliding_window" or seq_len > 65536:
        # long-context decode uses the sliding-window ring buffer
        return min(seq_len, cfg.sliding_window)
    return seq_len


def kv_cache_specs(cfg: ModelConfig, batch: int,
                   cache_len: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each decode-state leaf, stacked over the layers
    that hold it: the attention cache `k`, `v` (L,B,CL,KV,Dh), or MLA's
    latent cache `c_kv` (L,B,CL,r) and `k_rope` (L,B,CL,rope), over the
    attention layers; and the SSM state `conv` (L,B,d_conv-1,d_inner+2GN)
    in the model dtype and `ssd` (L,B,H,P,N) in float32, over the Mamba2
    layers. A hybrid or interleaved config holds all four (interleaved:
    k and v over its attention layers alone, conv and ssd over the
    rest)."""
    s: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.has_attention:
        cl = effective_cache_len(cfg, cache_len)
        s.update(_attention_specs(cfg, (cfg.n_attention_layers, batch, cl)))
    if cfg.has_ssm:
        L = cfg.n_ssm_layers
        s["conv"] = ((L, batch, cfg.d_conv - 1,
                      cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state),
                     cfg.dtype)
        s["ssd"] = ((L, batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), torch.float32)
    return s


def _attention_specs(cfg: ModelConfig, lead: Tuple[int, ...]
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The attention cache leaves with leading dims `lead`: MLA's latent
    `c_kv` and shared rope key `k_rope`, or GQA's `k` and `v`."""
    if cfg.use_mla:
        return {"c_kv": (lead + (cfg.kv_lora_rank,), cfg.dtype),
                "k_rope": (lead + (cfg.qk_rope_dim,), cfg.dtype)}
    shape = lead + (cfg.n_kv_heads, cfg.d_head)
    return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}


def paged_layout(cfg: ModelConfig, cache_len: int,
                 page_size: int) -> Tuple[int, int]:
    """(page_size, n_blocks) for a paged attention cache of logical length
    `cache_len`. page_size is reduced until it divides the cache length so
    every logical ring position maps to exactly one (block, offset)."""
    cl = effective_cache_len(cfg, cache_len)
    if cl == 0:
        return 0, 0
    ps = max(1, min(int(page_size), cl))
    while cl % ps:
        ps -= 1
    return ps, cl // ps


def paged_cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                      n_pages: int, page_size: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each paged decode-state leaf: the attention leaves
    become page pools (L, n_pages, page_size, KV, Dh) over the attention
    layers, MLA's (L, n_pages,
    page_size, r) and (..., rope), one physical page spanning every layer,
    so one host integer per logical block addresses both leaves. The
    (batch, n_blocks) block table lives on the host. SSM leaves are O(1)
    per slot, with nothing to page, and keep the slot layout of
    `kv_cache_specs`: a hybrid config has both pools and rows."""
    s: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.has_attention:
        ps, _ = paged_layout(cfg, cache_len, page_size)
        s.update(_attention_specs(cfg, (cfg.n_attention_layers, n_pages,
                                        ps)))
    if cfg.has_ssm:
        s.update({k: v for k, v in kv_cache_specs(cfg, batch,
                                                  cache_len).items()
                  if k in ("conv", "ssd")})
    return s


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def for_shape(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Specialize a config for an input shape (attention variant for 500k)."""
    if shape.name == "long_500k" and cfg.has_attention and not cfg.use_mla:
        return dataclasses.replace(cfg, attention_variant="sliding_window")
    return cfg


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of a step function (no
    storage is allocated):

    train  -> RL train batch (tokens, mask, behavior logprobs, rewards, ...)
    prefill-> prompt tokens
    decode -> one-token step against a KV cache of shape.seq_len
    """
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    specs: Dict[str, Any]
    if shape.kind == "train":
        # matches repro_torch.data.packing.pack output
        specs = {
            "tokens": _meta((B, S), i32),
            "loss_mask": _meta((B, S), f32),
            "behavior_logprobs": _meta((B, S), f32),
            "rewards": _meta((B, S), f32),
            "positions": _meta((B, S), i32),
            "segment_ids": _meta((B, S), i32),
        }
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((B, S), i32), "positions": _meta((B, S), i32)}
    else:  # decode: one new token, cache of length seq_len
        specs = {
            "tokens": _meta((B, 1), i32),
            "positions": _meta((B, 1), i32),
            "cache": {k: _meta(*v) for k, v in kv_cache_specs(cfg, B, S).items()},
            "cache_index": _meta((), i32),
        }
    if cfg.modality in ("vision", "audio") and cfg.n_prefix_tokens:
        # stubbed frontend: precomputed patch/frame embeddings
        specs["prefix_embeds"] = _meta((B, cfg.n_prefix_tokens, cfg.d_model),
                                       cfg.dtype)
    return specs


CACHE_LOGICAL = {
    "k": ("layers", "batch", "cache_seq", "kv_heads", None),
    "v": ("layers", "batch", "cache_seq", "kv_heads", None),
    "c_kv": ("layers", "batch", "cache_seq", None),
    "k_rope": ("layers", "batch", "cache_seq", None),
    "conv": ("layers", "batch", None, "mlp"),
    "ssd": ("layers", "batch", "heads", None, None),
}


def input_logical(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Logical axis names for every input spec (same keys as input_specs)."""
    two = ("batch", "seq")
    if shape.kind == "train":
        log: Dict[str, Any] = {k: two for k in (
            "tokens", "loss_mask", "behavior_logprobs", "rewards",
            "positions", "segment_ids")}
    elif shape.kind == "prefill":
        log = {"tokens": two, "positions": two}
    else:
        log = {
            "tokens": ("batch", None),
            "positions": ("batch", None),
            "cache": {k: CACHE_LOGICAL[k] for k in kv_cache_specs(cfg, 1, 8)},
            "cache_index": (),
        }
    if cfg.modality in ("vision", "audio") and cfg.n_prefix_tokens:
        log["prefix_embeds"] = ("batch", None, None)
    return log


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if n_heads % n_kv:
        n_kv = 1
    repl: Dict[str, Any] = dict(
        n_layers=2,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=32,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=64,
        ssm_head_dim=32 if cfg.has_ssm else cfg.ssm_head_dim,
        ssm_state=min(cfg.ssm_state, 16) if cfg.has_ssm else 0,
        ssm_chunk=16 if cfg.has_ssm else cfg.ssm_chunk,
        dtype=torch.float32,
    )
    if cfg.use_mla:
        repl.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                    qk_rope_dim=16, v_head_dim=32)
    if cfg.n_experts:
        repl.update(n_experts=min(cfg.n_experts, 4),
                    experts_per_token=min(cfg.experts_per_token, 2),
                    moe_d_ff=64, n_dense_layers=min(cfg.n_dense_layers, 1),
                    dense_d_ff=128 if cfg.dense_d_ff else 0)
    if cfg.n_prefix_tokens:
        repl.update(n_prefix_tokens=8)
    return dataclasses.replace(cfg, **repl)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """The HealthMonitor watchdog over the actor pool and the trainer's
    numerical-robustness policy. Detection only observes until a threshold
    trips, so a healthy run with the monitor on equals one without it."""
    enabled: bool = True
    # watchdog sweep cadence (flashes of simulated time)
    interval: float = 20.0
    # hang detection: heartbeat deadline = max(hang_grace,
    # hang_factor * EWMA inter-tick gap) per engine
    hang_grace: float = 120.0
    hang_factor: float = 8.0
    # straggler detection: speed-normalized EWMA tick cost vs the pool
    # minimum; must exceed the factor for `patience` consecutive sweeps
    straggler_factor: float = 2.5
    straggler_patience: int = 2
    # a prompt salvaged from this many failed or hung engines is
    # quarantined instead of requeued
    quarantine_after: int = 3
    # a detected hang is escalated to fail/salvage/requeue, and the engine
    # restarts this long after detection (None = leave it down)
    hang_restart_after: Optional[float] = 60.0
    # trainer: roll back to the newest intact checkpoint after this many
    # consecutive guarded-bad steps (0 = never)
    bad_step_rollback: int = 3
    # EWMA loss-spike detector: |loss| > factor * EWMA(|loss|) marks the
    # step bad (0.0 = off)
    loss_spike_factor: float = 0.0
    # rotated trainer_step_*.npz checkpoints kept for rollback
    ckpt_keep: int = 3
