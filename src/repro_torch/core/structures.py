"""Resource-aware tensor structures (paper §III-A), torch port.

Counterpart of ``src/repro/core/structures.py``.  A structure is a
``(bk, bn)`` block of the last two dims of a weight; leading dims become
independent planes.  ``iter_prunable`` walks nested dicts and lists in
the reference's pytree order (dict keys sorted, list items in order), so
the structure ids — and hence the knapsack's stable tie-breaks — line up
with the JAX package one for one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "BlockingSpec",
    "StructureInfo",
    "LayerStructures",
    "block_partition",
    "structure_norms_dense",
    "mask_from_selection",
    "iter_prunable",
    "iter_leaves",
    "PRUNABLE_MIN_SIZE",
]

# Tensors smaller than this (in elements) are never pruned.
PRUNABLE_MIN_SIZE = 1024


@dataclasses.dataclass(frozen=True)
class BlockingSpec:
    """Tile shape ``(bk, bn)`` over a weight's (in, out) dims, and ``C``:
    how many consecutive tiles form one memory super-block."""

    bk: int = 128
    bn: int = 128
    consecutive: int = 1

    def __post_init__(self):
        if self.bk <= 0 or self.bn <= 0 or self.consecutive <= 0:
            raise ValueError(f"invalid blocking {self}")


@dataclasses.dataclass(frozen=True)
class StructureInfo:
    """Static description of the structures of one weight tensor."""

    path: str                    # '/'-joined key path
    shape: Tuple[int, ...]       # full weight shape
    planes: int                  # product of leading dims
    grid_k: int                  # blocks along the in dim
    grid_n: int                  # blocks along the out dim
    blocking: BlockingSpec

    @property
    def num_structures(self) -> int:
        return self.planes * self.grid_k * self.grid_n

    @property
    def block_elems(self) -> int:
        return self.blocking.bk * self.blocking.bn

    def structure_index(self, plane: int, ik: int, in_: int) -> int:
        return (plane * self.grid_k + ik) * self.grid_n + in_


@dataclasses.dataclass
class LayerStructures:
    """All structures of a model; ids are contiguous per weight in
    ``infos`` order."""

    infos: List[StructureInfo]

    def layer_offsets(self) -> np.ndarray:
        sizes = np.array([i.num_structures for i in self.infos], dtype=np.int64)
        return np.concatenate([[0], np.cumsum(sizes)])

    @property
    def total_structures(self) -> int:
        return int(sum(i.num_structures for i in self.infos))


def _split_leading(shape: Sequence[int]) -> Tuple[int, int, int]:
    """(planes, K, N) from an arbitrary-rank weight shape."""
    if len(shape) == 0:
        return 1, 1, 1
    if len(shape) == 1:
        return 1, 1, shape[0]
    planes = int(np.prod(shape[:-2], dtype=np.int64)) if len(shape) > 2 else 1
    return planes, shape[-2], shape[-1]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def block_partition(path: str, shape: Sequence[int], blocking: BlockingSpec) -> StructureInfo:
    planes, k, n = _split_leading(shape)
    bk = min(blocking.bk, k)
    bn = min(blocking.bn, n)
    eff = BlockingSpec(bk=bk, bn=bn, consecutive=blocking.consecutive)
    return StructureInfo(
        path=path,
        shape=tuple(int(s) for s in shape),
        planes=planes,
        grid_k=_ceil_div(k, bk),
        grid_n=_ceil_div(n, bn),
        blocking=eff,
    )


def structure_norms_dense(w: torch.Tensor, info: StructureInfo) -> torch.Tensor:
    """Per-structure fp32 L2 norms, shape (planes, grid_k, grid_n), on
    ``w``'s device.  Tail tiles are zero-padded."""
    planes, k, n = _split_leading(tuple(w.shape))
    bk, bn = info.blocking.bk, info.blocking.bn
    w2 = w.reshape(planes, k, n).to(torch.float32)
    pk, pn = info.grid_k * bk - k, info.grid_n * bn - n
    if pk or pn:
        w2 = torch.nn.functional.pad(w2, (0, pn, 0, pk))
    w4 = w2.reshape(planes, info.grid_k, bk, info.grid_n, bn)
    return torch.sqrt(torch.sum(torch.square(w4), dim=(2, 4)))


def mask_from_selection(selected, info: StructureInfo, *,
                        device=None) -> torch.Tensor:
    """Expand a per-structure {0,1} selection (``info.num_structures``
    entries ordered (plane, ik, in)) into a float32 mask of
    ``info.shape``, built on ``device``."""
    sel = torch.as_tensor(np.asarray(selected, dtype=np.float32),
                          device=device).reshape(info.planes, info.grid_k,
                                                 info.grid_n)
    bk, bn = info.blocking.bk, info.blocking.bn
    big = sel.repeat_interleave(bk, dim=1).repeat_interleave(bn, dim=2)
    _, k, n = _split_leading(info.shape)
    return big[:, :k, :n].reshape(info.shape)


def iter_leaves(tree: Any, prefix: str = "") -> Iterable[Tuple[str, Any]]:
    """(path, leaf) over nested dicts (keys sorted, like a JAX pytree) and
    lists/tuples (in order); ``None`` leaves are skipped."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from iter_leaves(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from iter_leaves(item, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def iter_prunable(
    params: Mapping[str, Any],
    *,
    include: Optional[Sequence[str]] = None,
    exclude: Sequence[str] = ("norm", "scale", "bias_only", "embed_norm", "a_log", "dt", "gate_vec"),
    min_size: int = PRUNABLE_MIN_SIZE,
) -> Iterable[Tuple[str, torch.Tensor]]:
    """Yield (path, weight) for prunable matmul weights: ndim >= 2, at
    least ``min_size`` elements, path not matching ``exclude``."""
    for path, leaf in iter_leaves(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        if leaf.ndim < 2 or leaf.numel() < min_size:
            continue
        lowered = path.lower()
        if any(e in lowered for e in exclude):
            continue
        if include is not None and not any(i in lowered for i in include):
            continue
        yield path, leaf
