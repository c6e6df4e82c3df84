"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596.

Enc-dec transformer backbone: 24 encoder + 24 decoder layers, d_model=1024,
16H (GQA kv=16), d_ff=8192, vocab=256206 (padded to 256208 for 16-way TP).

The audio frontend is a STUB per the assignment: ``input_specs`` provides
precomputed speech frame embeddings (batch, src_len, d_model); the text
decoder consumes token ids.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,  # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256208,  # 256206 padded to a multiple of 16 (TP)
        block_pattern=("attn",),
        rope_theta=10_000.0,
        mlp_act="gelu",
        norm="layernorm",
        frontend="audio",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-reduced",
        family="audio",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=("attn",),
        rope_theta=10_000.0,
        mlp_act="gelu",
        norm="layernorm",
        frontend="audio",
    )


register("seamless-m4t-large-v2", full, reduced)
