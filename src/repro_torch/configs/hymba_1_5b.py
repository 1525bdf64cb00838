"""Hymba-1.5B: hybrid-head — parallel attention + Mamba(SSM) heads in every
layer, outputs fused. [arXiv:2411.13676]

Note: the paper also uses learnable meta tokens and cross-layer KV sharing;
we implement the core parallel-head fusion (the architectural signature) and
note the omission in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        arch_type="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_head=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_head_dim=64,
        expand=2,
        source="arXiv:2411.13676 (Hymba)",
    )
