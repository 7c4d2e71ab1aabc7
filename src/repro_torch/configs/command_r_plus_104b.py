"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, GQA, no biases.  [hf:CohereForAI/c4ai-command-r-v01]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="lm",
    vocab=256000,
    d_model=12288,
    n_layers=64,
    n_heads=96,
    kv_heads=8,
    d_ff=33792,
    norm_type="layernorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,           # cohere ties input/output embeddings
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat="full",                  # largest dense model: full remat
    sub_quadratic=False,
)
