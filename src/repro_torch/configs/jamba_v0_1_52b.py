"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave, MoE on
every other layer.  [arXiv:2403.19887]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    vocab=65536,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    moe_experts=16,
    moe_top_k=2,
    # period-8 block: attention at index 4, Mamba elsewhere (1:7)
    mixer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    # MoE every other layer, dense MLP otherwise
    mlp_pattern=("dense", "moe"),
    d_state=16,
    d_conv=4,
    ssm_chunk=512,
    norm_type="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat="dots",
    sub_quadratic=True,            # hybrid: SSM state + few attn layers
    notes="long_500k decode: mamba layers carry O(1) state; the 4 "
          "attention layers keep a full 512k KV cache sharded on kv_seq.",
)
