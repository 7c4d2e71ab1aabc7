"""Attention + dense-MLP language model stack of the torch port."""
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
