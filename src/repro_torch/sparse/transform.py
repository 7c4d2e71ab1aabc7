"""Params-tree sparse execution transform, torch port.

Counterpart of ``pack_params`` and ``sparsity_summary`` in
``src/repro/sparse/transform.py``.  ``pack_params`` replaces each
prunable 2-D ``kernel`` leaf with a ``BSRWeight`` packed on the weight's
own device, so every projection of the model routes through the BSR
kernel at ``models/layers.matmul``.  3-D (expert) weights need
``BSRPlanes``, which is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from repro_torch.core.masks import _get_path, _set_path, build_structures, map_tree
from repro_torch.core.packing import BSRWeight, pack_bsr
from repro_torch.core.structures import (
    PRUNABLE_MIN_SIZE,
    BlockingSpec,
    LayerStructures,
    iter_leaves,
)

__all__ = ["pack_params", "is_packed_leaf", "sparsity_summary"]


def is_packed_leaf(x: Any) -> bool:
    return isinstance(x, BSRWeight)


def pack_params(
    params: Mapping[str, Any],
    masks: Optional[Mapping[str, Any]] = None,
    structures: Optional[LayerStructures] = None,
    blocking: Optional[BlockingSpec] = None,
    *,
    min_size: int = PRUNABLE_MIN_SIZE,
    **iter_kwargs,
) -> Dict[str, Any]:
    """Replace prunable kernel leaves with BSR weights.  ``masks`` zeroes
    pruned tiles before packing; with ``masks=None`` only exactly-zero
    tiles drop.  Other leaves are shared, not copied."""
    if structures is None:
        if blocking is None:
            raise ValueError("pack_params needs either structures or blocking")
        structures = build_structures(
            params, blocking, min_size=min_size, **iter_kwargs
        )
    packed = map_tree(lambda leaf: leaf, dict(params))
    for info in structures.infos:
        w = _get_path(params, info.path)
        m = None if masks is None else _get_path(masks, info.path)
        if w.ndim != 2:
            raise NotImplementedError(
                f"{info.path}: packing {w.ndim}-D weights needs BSRPlanes, "
                "which the torch port does not have yet")
        _set_path(packed, info.path, pack_bsr(w, info.blocking, mask=m))
    return packed


def sparsity_summary(packed: Mapping[str, Any]) -> Dict[str, Any]:
    """Per-path and aggregate block density of a packed tree."""
    per_path: Dict[str, float] = {}
    nnz = total = 0
    for path, leaf in iter_leaves(packed):
        if not is_packed_leaf(leaf):
            continue
        per_path[path] = leaf.density()
        nnz += leaf.nnz_blocks
        total += leaf.grid_k * leaf.grid_n
    return {
        "per_path": per_path,
        "nnz_blocks": int(nnz),
        "total_blocks": int(total),
        "density": nnz / max(total, 1),
    }
