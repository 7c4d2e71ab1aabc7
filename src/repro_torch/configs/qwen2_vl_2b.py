"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE, dynamic resolution.  [arXiv:2409.12191]

The vision frontend is a stub, as in the reference: the caller passes
precomputed patch embeddings (B, num_patches, d_model) as
``batch["patch_embeds"]``; they replace the first ``num_patches`` token
positions.  M-RoPE uses (temporal, height,
width) position ids with frequency sections (16, 24, 24) over head_dim 128.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    vocab=151936,
    d_model=1536,
    n_layers=28,
    n_heads=12,
    kv_heads=2,
    d_ff=8960,
    head_dim=128,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    num_patches=1024,              # stub visual context length
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
