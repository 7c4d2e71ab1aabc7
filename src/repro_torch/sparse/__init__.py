"""repro_torch.sparse — knapsack pruning and BSR packing of a params tree."""
from .prune import DEFAULT_EXCLUDE, DEFAULT_INCLUDE, PruneSelection, knapsack_prune
from .transform import (is_packed_leaf, pack_params, planes_pspec, shard_experts,
                        sparsity_summary, unpack_params)

__all__ = [
    "is_packed_leaf", "pack_params", "planes_pspec", "shard_experts",
    "sparsity_summary", "unpack_params",
    "DEFAULT_EXCLUDE", "DEFAULT_INCLUDE", "PruneSelection", "knapsack_prune",
]
