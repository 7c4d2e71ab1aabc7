"""Model stacks of the torch port: attention, Mamba and xLSTM mixers with
dense-MLP, MoE or no MLP; whisper's encoder-decoder and Qwen2-VL's M-RoPE
with patch embeddings."""
from .transformer import (
    LayerSpec,
    cross_entropy_loss,
    encode_kv_caches,
    encoder_forward,
    init_caches,
    init_params,
    layer_specs,
    lm_decode,
    lm_forward,
    lm_generate,
    lm_prefill,
)

__all__ = [
    "LayerSpec", "cross_entropy_loss", "encode_kv_caches", "encoder_forward",
    "init_caches", "init_params", "layer_specs", "lm_decode", "lm_forward",
    "lm_generate", "lm_prefill",
]
