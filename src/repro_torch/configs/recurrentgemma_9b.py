"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin).

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000; block pattern
1 local-attention : 2 RG-LRU recurrent blocks (Griffin's 1:2 mix),
local window 2048, GeGLU MLP, RG-LRU width 4096, conv1d width 4.
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = ("rglru", "rglru", "local")


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=_PATTERN,
        window=2048,
        rope_theta=10_000.0,
        mlp_act="geglu",
        norm="rmsnorm",
        lru_width=4096,
        conv1d_width=4,
        tie_embeddings=True,
        emb_scale=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-reduced",
        family="hybrid",
        num_layers=5,  # one (rglru, rglru, local) group + 2 remainder layers
        d_model=64,
        num_heads=2,
        num_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        block_pattern=_PATTERN,
        window=16,
        rope_theta=10_000.0,
        mlp_act="geglu",
        norm="rmsnorm",
        lru_width=64,
        conv1d_width=4,
        tie_embeddings=True,
        emb_scale=True,
    )


register("recurrentgemma-9b", full, reduced)
