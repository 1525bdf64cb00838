"""Granite-3.0-1B-A400M: MoE, 32 experts top-8, GQA.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        arch_type="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_head=64,
        d_ff=512,       # per-expert ffn dim
        moe_d_ff=512,
        vocab_size=49155,
        n_experts=32,
        experts_per_token=8,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
