"""mixtral-8x7b [moe] — arXiv:2401.04088.

32L d_model=4096 32H (GQA kv=8) vocab=32000, MoE: 8 experts, top-2,
d_ff=14336 per expert, SwiGLU experts, sliding-window attention (4096).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        block_pattern=("swa",),
        window=4096,
        rope_theta=1_000_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=("swa",),
        window=16,
        rope_theta=1_000_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )


register("mixtral-8x7b", full, reduced)
