"""DeepSeek-V3-671B: MLA attention (compressed latent KV cache), MoE with
1 shared + 256 routed experts (top-8), multi-token prediction head.
[arXiv:2412.19437]

Assigned spec: 61L, d_model=7168, 128H, d_ff=2048 (per routed expert),
vocab=129280. Per the paper, the first 3 layers are dense with d_ff=18432.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,  # MLA: all heads read the shared compressed latent
        d_head=128,
        d_ff=2048,
        moe_d_ff=2048,
        vocab_size=129280,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=256,
        experts_per_token=8,
        n_shared_experts=1,
        n_dense_layers=3,
        dense_d_ff=18432,
        use_mtp=True,
        mtp_depth=1,
        source="arXiv:2412.19437 (DeepSeek-V3 technical report)",
    )
