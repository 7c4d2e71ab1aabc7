"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    vocab=49155,
    d_model=1024,
    n_layers=24,
    n_heads=16,
    kv_heads=8,
    d_ff=512,                      # per-expert FFN hidden
    moe_experts=32,
    moe_top_k=8,
    mlp_pattern=("moe",),
    norm_type="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat="dots",
    sub_quadratic=False,
    notes="vocab 49155 is not divisible by the 16-way TP axis -> embedding "
          "falls back to replication (table is only ~100MB in bf16).",
)
