"""Structures and masks over a params tree, torch port.

Counterpart of ``build_structures``, ``masks_from_knapsack``,
``_get_path`` and ``_set_path`` in ``src/repro/core/masks.py``.  Masks
mirror the params tree: prunable leaves get a {0,1} mask of the weight's
shape, dtype and device; every other leaf is ``None``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .structures import (
    BlockingSpec,
    LayerStructures,
    block_partition,
    iter_prunable,
    mask_from_selection,
)

__all__ = ["build_structures", "masks_from_knapsack", "map_tree"]


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


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(map_tree(fn, v) for v in tree)
    return fn(tree)


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
