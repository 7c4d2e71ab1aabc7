"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch.  [arXiv:2401.02954]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="lm",
    vocab=102400,
    d_model=8192,
    n_layers=95,
    n_heads=64,
    kv_heads=8,
    d_ff=22016,
    norm_type="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat="dots",
    sub_quadratic=False,
)
