"""One-shot knapsack pruning for serving (paper §III-B), torch port.

Counterpart of ``src/repro/sparse/prune.py``: layer-normalized structure
magnitudes (Eq. 4) as values, the per-structure resource vectors as
weights, one global MDKP at the requested sparsity:

    sel = knapsack_prune(params, sparsity=0.75, blocking=BlockingSpec())
    packed = pack_params(params, sel.masks, sel.structures)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.knapsack import KnapsackResult, solve_mdkp
from repro_torch.core.masks import _get_path, build_structures, masks_from_knapsack
from repro_torch.core.resource_model import TPUResourceModel
from repro_torch.core.structures import (
    BlockingSpec,
    LayerStructures,
    structure_norms_dense,
)

__all__ = ["PruneSelection", "knapsack_prune", "DEFAULT_INCLUDE", "DEFAULT_EXCLUDE"]

# matmul families the serving path packs; embeddings stay dense
DEFAULT_INCLUDE = ("mlp", "attn", "moe")
DEFAULT_EXCLUDE = (
    "norm", "scale", "bias_only", "embed", "a_log", "dt", "gate_vec", "router",
)


@dataclasses.dataclass
class PruneSelection:
    """Knapsack output bundled for packing and reporting."""

    masks: Dict[str, Any]
    structures: LayerStructures
    result: KnapsackResult
    sparsity: float

    @property
    def kept(self) -> int:
        return int(self.result.x.sum())

    @property
    def total(self) -> int:
        return int(self.result.x.size)


def knapsack_prune(
    params: Mapping[str, Any],
    *,
    sparsity: float,
    blocking: Optional[BlockingSpec] = None,
    include: Optional[Sequence[str]] = DEFAULT_INCLUDE,
    exclude: Sequence[str] = DEFAULT_EXCLUDE,
    min_size: int = 4096,
    resource_model: Optional[TPUResourceModel] = None,
) -> PruneSelection:
    """Solve one global MDKP at ``sparsity`` and expand the masks.  The
    budget is ``(1 - sparsity)`` of the baseline resource vector."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    blocking = blocking or BlockingSpec()
    rm = resource_model or TPUResourceModel(precision="bf16")
    structures = build_structures(
        params, blocking, include=include, exclude=exclude, min_size=min_size
    )
    if not structures.infos:
        raise ValueError(
            f"no prunable weights matched include={include} min_size={min_size}"
        )
    values, weights = [], []
    for info in structures.infos:
        w = _get_path(params, info.path)
        norms = structure_norms_dense(w, info).cpu().numpy().astype(np.float64).ravel()
        values.append(norms / max(float(norms.max()), 1e-12))
        weights.append(
            np.tile(rm.structure_cost(info.blocking)[:, None], (1, info.num_structures))
        )
    v = np.concatenate(values)
    u = np.concatenate(weights, axis=1)
    budget = u.sum(axis=1) * (1.0 - sparsity)
    result = solve_mdkp(v, u, budget)
    masks = masks_from_knapsack(params, structures, result.x.astype(np.float32))
    return PruneSelection(
        masks=masks, structures=structures, result=result, sparsity=float(sparsity)
    )
