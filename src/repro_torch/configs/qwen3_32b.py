"""Qwen3-32B: dense, GQA (64H/8KV), qk-norm. [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        arch_type="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,  # Qwen3 uses decoupled head_dim=128 (n_heads*d_head != d_model)
        d_ff=25600,
        vocab_size=151936,
        use_qk_norm=True,
        rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B (family); Qwen3 technical report",
    )
