"""MusicGen-medium: decoder-only transformer over EnCodec tokens; the
EnCodec/conditioning frontend is stubbed (input_specs provides precomputed
conditioning-frame embeddings as a prefix). [arXiv:2306.05284]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_head=64,
        d_ff=6144,
        vocab_size=2048,  # EnCodec codebook size
        modality="audio",
        n_prefix_tokens=64,  # stubbed T5/conditioning frames
        source="arXiv:2306.05284 (MusicGen: simple and controllable music generation)",
    )
