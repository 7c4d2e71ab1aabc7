"""whisper-tiny [audio] — 4L(+4L enc) d_model=384 6H (kv=6) d_ff=1536
vocab=51865, encoder-decoder, conv frontend (STUB).  [arXiv:2212.04356]

The conv/mel frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings (B, 1500, d_model) as ``batch["frames"]``
or to ``encoder_forward``.  Decoding runs the decoder on its self-attention
KV cache and the cross-attention K/V that ``encode_kv_caches`` stores.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    vocab=51865,
    d_model=384,
    n_layers=4,                    # decoder layers
    enc_layers=4,                  # encoder layers
    enc_frames=1500,
    n_heads=6,
    kv_heads=6,
    d_ff=1536,
    use_rope=False,                # whisper: sinusoidal/learned abs positions
    norm_type="layernorm",
    activation="gelu",
    gated_mlp=False,
    tie_embeddings=True,
    param_dtype="float32",         # tiny model: fp32 everywhere
    activ_dtype="bfloat16",
    remat="none",
    sub_quadratic=False,
)
