"""Granite-3.0-2B: dense, GQA (32H/8KV). [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        arch_type="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_head=64,
        d_ff=8192,
        vocab_size=49155,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
