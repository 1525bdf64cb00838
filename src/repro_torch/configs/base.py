"""Model config for the PyTorch port: the fields of the JAX package's
`ModelConfig` that the port reads, under the same names and with the same
defaults, with a torch dtype.

`arch_type` admits "dense" (the GQA decoder), "moe" (GQA or, with
`use_mla`, DeepSeek-V3's multi-head latent attention, with routed
experts), "ssm" (attention-free Mamba2 / SSD layers), "hybrid" (Hymba:
attention and SSM heads in parallel in every layer), "vlm" and "audio"
(the dense decoder behind a stubbed frontend's prefix embeddings). Left
out: `router_aux_coef` (the JAX package reads it nowhere; the Trainer
weighs the MoE loss by `RLConfig.aux_coef`) and `hybrid_parallel` (true
exactly when `arch_type` is "hybrid").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
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
        return self.arch_type in ("ssm", "hybrid")

    def param_count(self, active_only: bool = False) -> int:
        """Parameters of the embedding, the head and the layers (the JAX
        package's analytic count: no MTP head, value head or projector);
        `active_only` counts the k routed experts a token uses."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for li in range(self.n_layers):
            n += 2 * d  # the two norms
            if self.has_attention and self.use_mla:
                r, rope = self.kv_lora_rank, self.qk_rope_dim
                n += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + rope)
                n += d * (r + rope)
                n += r * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                n += self.n_heads * self.v_head_dim * d
            elif self.has_attention:
                n += 2 * d * self.n_heads * self.d_head  # q, o
                n += 2 * d * self.n_kv_heads * self.d_head  # k, v
            if self.has_ssm:
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
    """(shape, dtype) of each decode-state leaf, stacked over layers: the
    attention cache `k`, `v` (L,B,CL,KV,Dh), or MLA's latent cache `c_kv`
    (L,B,CL,r) and `k_rope` (L,B,CL,rope); and the SSM state `conv`
    (L,B,d_conv-1,d_inner+2GN) in the model dtype and `ssd` (L,B,H,P,N)
    in float32. A hybrid config holds all four."""
    L = cfg.n_layers
    s: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.has_attention:
        cl = effective_cache_len(cfg, cache_len)
        s.update(_attention_specs(cfg, (L, batch, cl)))
    if cfg.has_ssm:
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
    become page pools (L, n_pages, page_size, KV, Dh), MLA's (L, n_pages,
    page_size, r) and (..., rope), one physical page spanning every layer,
    so one host integer per logical block addresses both leaves. The
    (batch, n_blocks) block table lives on the host. SSM leaves are O(1)
    per slot, with nothing to page, and keep the slot layout of
    `kv_cache_specs`: a hybrid config has both pools and rows."""
    s: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.has_attention:
        ps, _ = paged_layout(cfg, cache_len, page_size)
        s.update(_attention_specs(cfg, (cfg.n_layers, n_pages, ps)))
    if cfg.has_ssm:
        s.update({k: v for k, v in kv_cache_specs(cfg, batch,
                                                  cache_len).items()
                  if k in ("conv", "ssd")})
    return s


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
