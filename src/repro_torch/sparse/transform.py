"""Params-tree sparse execution transform, torch port.

Counterpart of ``pack_params``, ``unpack_params``, ``sparsity_summary``
and ``planes_pspec`` in ``src/repro/sparse/transform.py``, plus the
expert slicing that ``planes_pspec`` implies (``shard_experts``).
``pack_params`` replaces each
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

__all__ = ["pack_params", "unpack_params", "is_packed_leaf", "sparsity_summary",
           "planes_pspec", "shard_experts"]

_PLANES_ARRAYS = ("indices", "slots", "blocks", "flat_rows", "flat_cols")


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


def planes_pspec(leaf: Any, plane_axis: str):
    """Which dims of an expert-weight leaf go on ``plane_axis``: a dense
    (E, D, F) stack shards its plane dim, ``(plane_axis, None, None)``; a
    ``BSRPlanes`` leaf gets ``{array name: spec}`` with the plane dim of
    every component array on the axis (the per-plane index maps and tile
    stores ride along whole within a shard)."""
    if isinstance(leaf, BSRPlanes):
        return {name: (plane_axis,) + (None,) * (getattr(leaf, name).ndim - 1)
                for name in _PLANES_ARRAYS}
    return (plane_axis, None, None)


def _slice_planes(leaf: Any, lo: int, hi: int) -> Any:
    if isinstance(leaf, BSRPlanes):
        return BSRPlanes(
            **{name: getattr(leaf, name)[lo:hi] for name in _PLANES_ARRAYS},
            shape=(hi - lo, *leaf.shape[1:]), blocking=leaf.blocking,
            plane_nnz=leaf.plane_nnz[lo:hi])
    return leaf[lo:hi]


def shard_experts(moe_params: Mapping[str, Any], rank: int,
                  size: int) -> Dict[str, Any]:
    """The experts of shard ``rank`` of ``size`` along the plane dim, as
    ``planes_pspec`` lays them out: experts ``[rank * E / size, (rank + 1)
    * E / size)`` of every ``experts_*`` leaf, dense or ``BSRPlanes``
    (every component array sliced, ``shape[0]`` and ``plane_nnz`` sliced
    to match).  The router stays whole.  The slices are views."""
    out: Dict[str, Any] = {}
    for name, leaf in moe_params.items():
        if not name.startswith("experts_"):
            out[name] = leaf
            continue
        e = int(leaf.shape[0])
        if e % size:
            raise ValueError(f"shard_experts: {e} experts of {name} do not "
                             f"split over {size} shards")
        per = e // size
        out[name] = _slice_planes(leaf, rank * per, (rank + 1) * per)
    return out
