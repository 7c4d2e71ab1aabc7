"""deepseek-7b [dense] — 30L d_model=4096 32H (MHA kv=32) d_ff=11008
vocab=102400, llama-arch.  [arXiv:2401.02954]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="lm",
    vocab=102400,
    d_model=4096,
    n_layers=30,
    n_heads=32,
    kv_heads=32,
    d_ff=11008,
    norm_type="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat="dots",
    sub_quadratic=False,
)
