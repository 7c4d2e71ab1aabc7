"""repro_torch.core — resource-aware structured pruning, torch port.

* structures       resource-aware tensor structures (MXU-tile blocks)
* resource_model   vector resource estimation R(w)
* knapsack         MDKP solvers (Eq. 5-8), numpy
* masks            structures, mask trees and sparsity accounting
* packing          BSR packing for the zero-skipping serving path (§III-C)
* schedule         sparsity schedules f(s) of Algorithm 2
* regularizer      resource-aware group lasso (§III-C)
* pruner           Algorithm 2: score, knapsack, mask, fine-tune, evaluate
"""
from .knapsack import KnapsackResult, solve_brute, solve_dp, solve_greedy, solve_mdkp
from .masks import (
    apply_masks,
    build_structures,
    count_zero_structures,
    init_masks,
    masks_from_knapsack,
    sparsity_report,
)
from .packing import BSRPlanes, BSRWeight, bsr_to_dense, pack_bsr
from .pruner import IterativePruner, PruneConfig, PruneIterationLog
from .regularizer import group_lasso, make_regularizer
from .resource_model import TPU_V5E, HardwareSpec, TPUResourceModel, consecutive_groups
from .schedule import SparsitySchedule, constant_step, cubic
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
    "apply_masks", "build_structures", "count_zero_structures", "init_masks",
    "masks_from_knapsack", "sparsity_report",
    "BSRPlanes", "BSRWeight", "bsr_to_dense", "pack_bsr",
    "IterativePruner", "PruneConfig", "PruneIterationLog",
    "group_lasso", "make_regularizer",
    "SparsitySchedule", "constant_step", "cubic",
    "TPU_V5E", "HardwareSpec", "TPUResourceModel", "consecutive_groups",
    "BlockingSpec", "LayerStructures", "StructureInfo", "block_partition",
    "iter_prunable", "mask_from_selection", "structure_norms_dense",
]
