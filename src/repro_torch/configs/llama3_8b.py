"""Llama-3-8B: dense, GQA (32H/8KV), 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=5e5,
        source="arXiv:2407.21783 (Llama 3 herd of models)",
    )
