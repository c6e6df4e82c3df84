"""llama3.2-1b [dense] — hf:meta-llama/Llama-3.2-1B.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        block_pattern=("attn",),
        rope_theta=500_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-reduced",
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
        tie_embeddings=True,
    )


register("llama3.2-1b", full, reduced)
