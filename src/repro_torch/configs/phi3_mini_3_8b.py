"""Phi-3-mini-3.8B: dense, RoPE, SwiGLU, MHA (kv=32 == heads). [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        arch_type="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab_size=32064,
        rope_theta=1e4,
        source="arXiv:2404.14219 (Phi-3 technical report)",
    )
