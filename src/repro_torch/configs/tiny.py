"""Tiny dense config for the CPU RL experiments (learning-curve studies,
examples, tests). Same family as the paper's Qwen-2.5-7B runs (dense GQA
decoder), scaled to run hundreds of optimizer steps on one CPU."""
import torch

from repro_torch.configs.base import ModelConfig


def config(vocab_size: int = 32, d_model: int = 128, n_layers: int = 2,
           use_value_head: bool = True) -> ModelConfig:
    return ModelConfig(
        name="tiny-rl",
        arch_type="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=4 * d_model,
        vocab_size=vocab_size,
        dtype=torch.float32,
        use_value_head=use_value_head,
        tie_embeddings=True,
        source="repro-internal (CPU-scale RL testbed)",
    )
