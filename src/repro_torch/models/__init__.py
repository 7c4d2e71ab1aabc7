"""Attention + dense-MLP language model stack of the torch port."""
from .transformer import (
    LayerSpec,
    init_caches,
    init_params,
    layer_specs,
    lm_decode,
    lm_generate,
    lm_prefill,
)

__all__ = [
    "LayerSpec", "init_caches", "init_params", "layer_specs", "lm_decode",
    "lm_generate", "lm_prefill",
]
