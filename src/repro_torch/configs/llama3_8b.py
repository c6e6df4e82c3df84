"""llama3-8b [dense] — arXiv:2407.21783.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, RoPE θ=500k, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        block_pattern=("attn",),
        rope_theta=500_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=("attn",),
        rope_theta=500_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
    )


register("llama3-8b", full, reduced)
