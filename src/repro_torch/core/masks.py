"""Structures and masks over a params tree, torch port of
``src/repro/core/masks.py``.

Masks mirror the params tree: prunable leaves get a {0,1} mask of the
weight's shape, dtype and device; every other leaf is ``None``.  The
sparsity accounting (``count_zero_structures``, ``sparsity_report``)
reduces each mask on its own device and brings back only the counts.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .structures import (
    BlockingSpec,
    LayerStructures,
    StructureInfo,
    block_partition,
    iter_leaves,
    iter_prunable,
    mask_from_selection,
)

__all__ = [
    "build_structures", "init_masks", "apply_masks", "masks_from_knapsack",
    "sparsity_report", "count_zero_structures", "map_tree", "tree_leaves",
    "copy_tree_",
]


def build_structures(
    params: Mapping[str, Any],
    blocking: BlockingSpec | Mapping[str, BlockingSpec],
    **iter_kwargs,
) -> LayerStructures:
    """Partition every prunable weight into structures.  ``blocking`` is
    one spec or a per-path mapping with a ``"default"`` entry."""
    infos = []
    for path, w in iter_prunable(params, **iter_kwargs):
        if isinstance(blocking, BlockingSpec):
            spec = blocking
        else:
            spec = blocking.get(path, blocking.get("default"))
            if spec is None:
                raise KeyError(f"no blocking spec for {path} and no default")
        infos.append(block_partition(path, tuple(w.shape), spec))
    return LayerStructures(infos=infos)


def map_tree(fn, tree, *rest):
    """Apply ``fn`` to every leaf of nested dicts/lists/tuples.  With
    ``rest``, trees of the same structure, ``fn`` gets the matching leaf
    of each (``None`` where a mask tree has no mask)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Non-``None`` leaves in the reference's pytree order (dict keys
    sorted, list items in order)."""
    return [leaf for _, leaf in iter_leaves(tree)]


def copy_tree_(dst, src) -> None:
    """``dst.copy_(src)`` leaf by leaf over two trees of one layout (the
    same paths; ``None`` leaves are skipped), as one batched copy."""
    d, s = list(iter_leaves(dst)), list(iter_leaves(src))
    if [p for p, _ in d] != [p for p, _ in s]:
        raise ValueError("copy_tree_: the trees' layouts differ")
    if d:
        torch._foreach_copy_([t for _, t in d], [t for _, t in s])


def _get_path(tree: Mapping[str, Any], path: str):
    node = tree
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def _set_path(tree: Dict[str, Any], path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for part in parts[:-1]:
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def masks_from_knapsack(
    params: Mapping[str, Any],
    structures: LayerStructures,
    selection: np.ndarray,
) -> Dict[str, Any]:
    """Expand a global knapsack selection vector into a mask tree."""
    offsets = structures.layer_offsets()
    masks = map_tree(lambda _: None, dict(params))
    for li, info in enumerate(structures.infos):
        sel = selection[offsets[li]: offsets[li + 1]]
        w = _get_path(params, info.path)
        m = mask_from_selection(sel, info, device=w.device)
        _set_path(masks, info.path, m.to(w.dtype))
    return masks


def init_masks(params: Mapping[str, Any], structures: LayerStructures) -> Dict[str, Any]:
    """All-ones masks (sparsity 0) shaped like the prunable leaves."""
    masks = map_tree(lambda _: None, dict(params))
    for info in structures.infos:
        w = _get_path(params, info.path)
        _set_path(masks, info.path, torch.ones(w.shape, dtype=w.dtype,
                                               device=w.device))
    return masks


def apply_masks(params: Mapping[str, Any], masks: Optional[Mapping[str, Any]]):
    """Elementwise params * mask where a mask exists."""
    if masks is None:
        return params
    return map_tree(lambda p, m: p if m is None else p * m.to(p.dtype),
                    dict(params), dict(masks))


def count_zero_structures(masks: Mapping[str, Any],
                          structures: LayerStructures) -> Tuple[int, int]:
    """(pruned, total) structure counts implied by a mask tree."""
    pruned = 0
    for info in structures.infos:
        sel = _selection_from_mask(_get_path(masks, info.path), info)
        pruned += int(np.sum(sel == 0))
    return pruned, structures.total_structures


def _selection_from_mask(mask: torch.Tensor, info: StructureInfo) -> np.ndarray:
    """Per-structure {0,1} int8 selection: 1 where any entry of the tile
    is nonzero."""
    k = info.shape[-2] if len(info.shape) >= 2 else 1
    n = info.shape[-1]
    m2 = torch.as_tensor(mask).reshape(info.planes, k, n).abs().to(torch.float32)
    bk, bn = info.blocking.bk, info.blocking.bn
    pk, pn = info.grid_k * bk - k, info.grid_n * bn - n
    if pk or pn:
        m2 = torch.nn.functional.pad(m2, (0, pn, 0, pk))
    m4 = m2.reshape(info.planes, info.grid_k, bk, info.grid_n, bn)
    live = m4.sum(dim=(2, 4)) > 0
    return live.cpu().numpy().astype(np.int8).reshape(-1)


def sparsity_report(
    params: Mapping[str, Any],
    masks: Mapping[str, Any],
    structures: LayerStructures,
) -> Dict[str, float]:
    """Weight- and structure-level sparsity, global and per-layer."""
    report: Dict[str, float] = {}
    zeros = 0
    total = 0
    for info in structures.infos:
        m = _get_path(masks, info.path)
        z = int((m == 0).sum())
        t = int(m.numel())
        report[f"layer/{info.path}"] = z / max(t, 1)
        zeros += z
        total += t
    report["weight_sparsity"] = zeros / max(total, 1)
    p, t = count_zero_structures(masks, structures)
    report["structure_sparsity"] = p / max(t, 1)
    return report
