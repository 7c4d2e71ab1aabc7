"""Hand-written Hopper kernels of the port, each with its plain version.

* block_sparse_matmul — BSR matmul with the fused epilogue, for one
  weight (``csrc/bsr_matmul.cu``) and for a stack of expert planes in
  one launch with per-segment row counts (``csrc/bsr_planes_matmul.cu``),
  both on the body ``csrc/bsr_split.cuh``
* paged_attention     — paged decode (context chunks merged through a
  thread-block cluster) and causal prefill with an online softmax over
  the page walk (``csrc/paged_decode.cu``, ``csrc/paged_prefill.cu``)
* structure_norms     — per-tile L2 norms (``csrc/structure_norms.cu``)

``ops`` dispatches by device; ``launch_counts`` counts kernel launches.
"""
from ._build import launch_counts, reset_launch_counts
from .epilogue import Epilogue, apply_epilogue, make_epilogue
from .ops import (
    bsr_matmul,
    bsr_planes_matmul,
    paged_attention_decode,
    paged_attention_prefill,
    structure_norms,
)

__all__ = [
    "Epilogue", "apply_epilogue", "make_epilogue",
    "bsr_matmul", "bsr_planes_matmul", "paged_attention_decode",
    "paged_attention_prefill", "structure_norms",
    "launch_counts", "reset_launch_counts",
]
