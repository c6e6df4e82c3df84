"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) vocab=151936, MoE: 60 routed experts top-4
with d_ff=1408 each + 4 shared experts (shared hidden 4*1408=5632),
attention qkv bias (qwen style).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        block_pattern=("attn",),
        attn_bias=True,
        rope_theta=1_000_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            d_ff_expert=1408,
            num_shared_experts=4,
            d_ff_shared=5632,
        ),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        block_pattern=("attn",),
        attn_bias=True,
        rope_theta=1_000_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(
            num_experts=8, top_k=4, d_ff_expert=64, num_shared_experts=2, d_ff_shared=128
        ),
    )


register("qwen2-moe-a2.7b", full, reduced)
