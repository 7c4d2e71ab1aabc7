"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    vocab=32000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    moe_experts=8,
    moe_top_k=2,
    mlp_pattern=("moe",),
    window=4096,                    # SWA => ring-buffer cache, long_500k ok
    norm_type="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat="dots",
    sub_quadratic=True,
    notes="E=8 experts on a 16-way model axis: EP falls back to "
          "intra-expert TP (DESIGN.md §4). SWA window 4096 bounds the "
          "decode cache, so long_500k runs with a ring buffer.",
)
