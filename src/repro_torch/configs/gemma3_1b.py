"""gemma3-1b [dense] — hf:google/gemma-3-1b-pt.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144; 5 local : 1 global
attention pattern (window 512), separate RoPE θ for local (10k) vs global (1M),
GeGLU, RMSNorm, tied embeddings, embedding scaling by sqrt(d_model).
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = ("local", "local", "local", "local", "local", "attn")


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        num_layers=26,
        d_model=1152,
        num_heads=4,
        num_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262144,
        block_pattern=_PATTERN,
        window=512,
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        mlp_act="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        emb_scale=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-reduced",
        family="dense",
        num_layers=6,  # one full 5:1 pattern group
        d_model=64,
        num_heads=2,
        num_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        block_pattern=_PATTERN,
        window=16,
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        mlp_act="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        emb_scale=True,
    )


register("gemma3-1b", full, reduced)
