"""Decoder stacks of the torch port: attention, Mamba and xLSTM mixers with
dense-MLP, MoE or no MLP."""
from .transformer import (
    LayerSpec,
    cross_entropy_loss,
    init_caches,
    init_params,
    layer_specs,
    lm_decode,
    lm_forward,
    lm_generate,
    lm_prefill,
)

__all__ = [
    "LayerSpec", "cross_entropy_loss", "init_caches", "init_params",
    "layer_specs", "lm_decode", "lm_forward", "lm_generate", "lm_prefill",
]
