"""Params-tree sparse execution transform, torch port.

Counterpart of ``pack_params``, ``unpack_params`` and
``sparsity_summary`` in ``src/repro/sparse/transform.py``.  ``pack_params`` replaces each
prunable 2-D ``kernel`` leaf with a ``BSRWeight`` and each 3-D (expert)
leaf with a ``BSRPlanes``, packed on the weight's own device, so every
projection routes through the BSR kernel at ``models/layers.matmul`` and
every expert stack through the planes kernel at
``models/layers.expert_matmul``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.core.masks import _get_path, _set_path, build_structures, map_tree
from repro_torch.core.packing import BSRPlanes, BSRWeight, bsr_to_dense, pack_bsr
from repro_torch.core.structures import (
    PRUNABLE_MIN_SIZE,
    BlockingSpec,
    LayerStructures,
    iter_leaves,
)

__all__ = ["pack_params", "unpack_params", "is_packed_leaf", "sparsity_summary"]


def is_packed_leaf(x: Any) -> bool:
    return isinstance(x, (BSRWeight, BSRPlanes))


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
        if w.ndim == 2:
            leaf: Any = pack_bsr(w, info.blocking, mask=m)
        else:
            k, n = w.shape[-2], w.shape[-1]
            w3 = w.reshape(info.planes, k, n)
            m3 = None if m is None else m.reshape(info.planes, k, n)
            leaf = BSRPlanes.from_planes(
                tuple(pack_bsr(w3[e], info.blocking,
                               mask=None if m3 is None else m3[e])
                      for e in range(info.planes)),
                shape=tuple(int(s) for s in w.shape))
        _set_path(packed, info.path, leaf)
    return packed


def unpack_params(packed: Mapping[str, Any]) -> Dict[str, Any]:
    """Dense reconstruction of a packed tree, the test oracle: every
    ``BSRWeight`` / ``BSRPlanes`` leaf becomes the masked dense weight
    (pruned tiles exactly zero); other leaves pass through."""

    def leaf_fn(x):
        if isinstance(x, BSRWeight):
            return bsr_to_dense(x)
        if isinstance(x, BSRPlanes):
            return torch.stack([bsr_to_dense(p) for p in x.planes]).reshape(x.shape)
        return x

    return map_tree(leaf_fn, dict(packed))


def sparsity_summary(packed: Mapping[str, Any]) -> Dict[str, Any]:
    """Per-path and aggregate block density of a packed tree."""
    per_path: Dict[str, float] = {}
    nnz = total = 0
    for path, leaf in iter_leaves(packed):
        if not is_packed_leaf(leaf):
            continue
        per_path[path] = leaf.density()
        nnz += leaf.nnz_blocks
        planes = leaf.num_planes if isinstance(leaf, BSRPlanes) else 1
        total += planes * leaf.grid_k * leaf.grid_n
    return {
        "per_path": per_path,
        "nnz_blocks": int(nnz),
        "total_blocks": int(total),
        "density": nnz / max(total, 1),
    }
