"""rwkv6-7b [ssm] — arXiv:2404.05892 (Eagle/Finch).

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536; RWKV6 "Finch"
time-mix with data-dependent decay (per-channel, per-step) + channel-mix.
wkv head dim 64 → 64 heads.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,  # wkv heads = d_model / rwkv_head_dim
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        block_pattern=("rwkv",),
        mlp_act="relu2",  # rwkv channel-mix uses squared relu
        norm="layernorm",
        rwkv_head_dim=64,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=("rwkv",),
        mlp_act="relu2",
        norm="layernorm",
        rwkv_head_dim=16,
    )


register("rwkv6-7b", full, reduced)
