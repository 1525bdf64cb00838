"""Granite-4.0-H-Micro: 40 layers at d 2048, 36 Mamba2 layers (64 heads of
64, state 128, one group, conv 4) and 4 NoPE GQA layers (32/8 heads of
64) interleaved, a SwiGLU MLP of 8192 in every layer.
[hf:ibm-granite/granite-4.0-h-micro]

The port's departures from the published model are granite-3-2b's: no
Granite multipliers (embedding, attention, residual, logits), an untied
head and RMSNorm eps 1e-6; and the SSD scan in blocks of 64 tokens, the
engine's prefill chunk, where the published chunk is 256 (a blocking of
the same sums: a 64-token chunk would be padded to 256).
"""
from repro_torch.configs.base import ModelConfig

# the published `layer_types`: attention at layers 5, 15, 25 and 35
PATTERN = "".join("A" if l % 10 == 5 else "M" for l in range(40))


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-micro",
        arch_type="interleaved",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_head=64,
        d_ff=8192,
        vocab_size=100352,
        position_embedding="nope",
        ssm_state=128,
        ssm_n_groups=1,
        ssm_chunk=64,
        ssm_head_dim=64,
        d_conv=4,
        expand=2,
        layer_pattern=PATTERN,
        source="hf:ibm-granite/granite-4.0-h-micro",
    )
