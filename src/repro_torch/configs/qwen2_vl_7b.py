"""qwen2-vl-7b [vlm] — arXiv:2409.12191.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, M-RoPE
(3-section rotary: temporal/height/width), qkv bias.

The vision frontend is a STUB per the assignment: ``input_specs`` provides
precomputed patch embeddings; the backbone consumes embeddings directly.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        block_pattern=("attn",),
        attn_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # half-dim sections: t/h/w
        mlp_act="swiglu",
        norm="rmsnorm",
        frontend="vision",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-reduced",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=("attn",),
        attn_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(2, 3, 3),
        mlp_act="swiglu",
        norm="rmsnorm",
        frontend="vision",
    )


register("qwen2-vl-7b", full, reduced)
