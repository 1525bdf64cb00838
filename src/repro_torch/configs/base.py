"""Model config for the PyTorch port: the dense-decoder fields of the JAX
package's `ModelConfig`, under the same names, with a torch dtype.

Only the dense GQA decoder is ported so far; the MLA, MoE, SSM and
multimodal fields arrive with the slices that port those paths.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # only "dense" is ported
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


def effective_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer cache length actually allocated for a decode shape."""
    if cfg.attention_variant == "sliding_window" or seq_len > 65536:
        # long-context decode uses the sliding-window ring buffer
        return min(seq_len, cfg.sliding_window)
    return seq_len


def kv_cache_specs(cfg: ModelConfig, batch: int,
                   cache_len: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each decode-state leaf, stacked over layers."""
    cl = effective_cache_len(cfg, cache_len)
    shape = (cfg.n_layers, batch, cl, cfg.n_kv_heads, cfg.d_head)
    return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
