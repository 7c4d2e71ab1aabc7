"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="lm",
    vocab=151936,
    d_model=1024,
    n_layers=24,
    n_heads=16,
    kv_heads=16,
    d_ff=2816,
    qkv_bias=True,
    rope_theta=1e6,
    norm_type="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat="dots",
    sub_quadratic=False,
)
