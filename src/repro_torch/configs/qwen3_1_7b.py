"""Qwen3-1.7B — dense transformer with QK-norm.

[hf:Qwen/Qwen3-8B family; hf] 28L d_model=2048 16H (GQA kv=8)
d_ff=6144 vocab=151936, qk_norm, GQA, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_1_7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    activation="swiglu",
    rope="rope",
    rope_theta=1000000.0,
    tie_embeddings=True,
    norm="rmsnorm",
    source="hf:Qwen/Qwen3-1.7B",
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        name="qwen3_1_7b_reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
