"""repro_torch.core — resource-aware structured pruning, torch port.

* structures       resource-aware tensor structures (MXU-tile blocks)
* resource_model   vector resource estimation R(w)
* knapsack         MDKP solvers (Eq. 5-8), numpy
* masks            structures and mask trees over a params tree
* packing          BSR packing for the zero-skipping serving path (§III-C)
"""
from .knapsack import KnapsackResult, solve_brute, solve_dp, solve_greedy, solve_mdkp
from .masks import build_structures, masks_from_knapsack
from .packing import BSRPlanes, BSRWeight, bsr_to_dense, pack_bsr
from .resource_model import TPU_V5E, HardwareSpec, TPUResourceModel, consecutive_groups
from .structures import (
    BlockingSpec,
    LayerStructures,
    StructureInfo,
    block_partition,
    iter_prunable,
    mask_from_selection,
    structure_norms_dense,
)

__all__ = [
    "KnapsackResult", "solve_brute", "solve_dp", "solve_greedy", "solve_mdkp",
    "build_structures", "masks_from_knapsack",
    "BSRPlanes", "BSRWeight", "bsr_to_dense", "pack_bsr",
    "TPU_V5E", "HardwareSpec", "TPUResourceModel", "consecutive_groups",
    "BlockingSpec", "LayerStructures", "StructureInfo", "block_partition",
    "iter_prunable", "mask_from_selection", "structure_norms_dense",
]
