"""Mamba2-2.7B: attention-free SSM with SSD (state-space duality) layers.
[arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        arch_type="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_head=0,
        d_ff=0,           # attention-free, no separate MLP (Mamba2 block only)
        vocab_size=50280,
        ssm_state=128,
        ssm_n_groups=1,
        ssm_head_dim=64,
        expand=2,
        ssm_chunk=64,
        source="arXiv:2405.21060 (Transformers are SSMs / Mamba-2)",
    )
