"""nemotron-4-15b [dense] — arXiv:2402.16819.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU MLP
(no gate), LayerNorm, untied embeddings, RoPE.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        block_pattern=("attn",),
        rope_theta=10_000.0,
        mlp_act="relu2",
        norm="layernorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-reduced",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        block_pattern=("attn",),
        rope_theta=10_000.0,
        mlp_act="relu2",
        norm="layernorm",
    )


register("nemotron-4-15b", full, reduced)
