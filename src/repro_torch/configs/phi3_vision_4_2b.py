"""Phi-3-vision-4.2B: phi3-mini backbone + CLIP ViT frontend (stubbed —
input_specs provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        arch_type="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab_size=32064,
        rope_theta=1e4,
        modality="vision",
        n_prefix_tokens=576,  # CLIP ViT-L/14 @336: (336/14)^2 = 576 patches
        source="hf:microsoft/Phi-3-vision-128k-instruct",
    )
