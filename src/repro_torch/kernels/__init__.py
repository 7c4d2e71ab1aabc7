"""Hand-written Hopper kernels of the port, each with its plain version.

* block_sparse_matmul — BSR matmul with the fused epilogue
  (``csrc/bsr_matmul.cu``)
* paged_attention     — paged decode and causal prefill with an online
  softmax over the page walk (``csrc/paged_decode.cu``,
  ``csrc/paged_prefill.cu``)

``ops`` dispatches by device; ``launch_counts`` counts kernel launches.
"""
from ._build import launch_counts, reset_launch_counts
from .epilogue import Epilogue, apply_epilogue, make_epilogue
from .ops import bsr_matmul, paged_attention_decode, paged_attention_prefill

__all__ = [
    "Epilogue", "apply_epilogue", "make_epilogue",
    "bsr_matmul", "paged_attention_decode", "paged_attention_prefill",
    "launch_counts", "reset_launch_counts",
]
