"""Dense+mask -> BSR packing (paper §III-C), torch port.

Counterpart of ``BSRWeight``, ``pack_bsr`` (:207) and ``bsr_to_dense``
in ``src/repro/core/packing.py``, with the identical layout:

* flat store — live tiles only, column-major over (block-col, slot):
  ``blocks (nnz, bk, bn)``, ``flat_rows (nnz,)`` K-block and
  ``flat_cols (nnz,)`` N-block of each live tile (sorted).  At least one
  slot: a fully pruned weight stores one zero block at (0, 0).
* per-column map — ``indices (grid_n, max_nnz)`` K-block per slot, -1
  padded; ``slots (grid_n, max_nnz)`` index into the flat store, 0
  padded.

Packing runs with torch ops on the weight's own device: the reference
packs with numpy, which has no bfloat16, while the full config's params
are bf16 and live on the card.

``BSRPlanes`` (reference :96) stacks the per-plane ``BSRWeight``s of a
3-D (MoE expert) weight into one rectangular layout, so the whole
expert stack is one kernel launch: the per-column slot dim pads to the
stack-wide ``max_nnz`` (indices -1, slots 0), the flat store pads with
zero blocks to the largest plane's count, and ``flat_cols`` pads with
``grid_n - 1`` so every plane's column ids stay sorted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .structures import BlockingSpec

__all__ = ["BSRWeight", "BSRPlanes", "pack_bsr", "bsr_to_dense"]


@dataclasses.dataclass
class BSRWeight:
    """Block-sparse weight for a (K, N) matmul, tiles of (bk, bn)."""

    indices: torch.Tensor     # (grid_n, max_nnz) int32, -1 padded
    slots: torch.Tensor       # (grid_n, max_nnz) int32 into blocks, 0 padded
    blocks: torch.Tensor      # (nnz, bk, bn) flat store, column-major
    flat_rows: torch.Tensor   # (nnz,) int32 K-block per live tile
    flat_cols: torch.Tensor   # (nnz,) int32 N-block per live tile, sorted
    shape: Tuple[int, int]    # dense (K, N)
    blocking: BlockingSpec
    nnz_blocks: int           # true live count (blocks may pad to >= 1)

    @property
    def grid_k(self) -> int:
        return -(-self.shape[0] // self.blocking.bk)

    @property
    def grid_n(self) -> int:
        return self.indices.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    def density(self) -> float:
        return self.nnz_blocks / max(self.grid_k * self.grid_n, 1)


@dataclasses.dataclass
class BSRPlanes:
    """Flattened per-plane BSR stack for a >2-D weight (MoE (E, D, F))."""

    indices: torch.Tensor     # (E, grid_n, max_nnz) int32, -1 padded
    slots: torch.Tensor       # (E, grid_n, max_nnz) int32, 0 padded
    blocks: torch.Tensor      # (E, nnz_pad, bk, bn) flat stores
    flat_rows: torch.Tensor   # (E, nnz_pad) int32, 0 padded
    flat_cols: torch.Tensor   # (E, nnz_pad) int32, sorted, grid_n-1 padded
    shape: Tuple[int, ...]    # full dense shape, leading dims included
    blocking: BlockingSpec    # effective (clamped) tile shape
    plane_nnz: Tuple[int, ...]  # true live count per plane

    @classmethod
    def from_planes(cls, planes: Tuple[BSRWeight, ...],
                    shape: Tuple[int, ...]) -> "BSRPlanes":
        """Concatenate per-plane BSRWeights (same (K, N) and blocking)
        into the fused layout, padded to the stack-wide maxima."""
        max_nnz = max(p.max_nnz for p in planes)
        nnz_pad = max(p.blocks.shape[0] for p in planes)
        gn = planes[0].grid_n
        pad = torch.nn.functional.pad
        idx, slt, blk, fr, fc = [], [], [], [], []
        for p in planes:
            spad = max_nnz - p.max_nnz
            zpad = nnz_pad - p.blocks.shape[0]
            idx.append(pad(p.indices, (0, spad), value=-1))
            slt.append(pad(p.slots, (0, spad)))
            blk.append(pad(p.blocks, (0, 0, 0, 0, 0, zpad)))
            fr.append(pad(p.flat_rows, (0, zpad)))
            # the last column id, not 0: keeps each plane's ids sorted
            # (the zero padding blocks add nothing wherever they point)
            fc.append(pad(p.flat_cols, (0, zpad), value=gn - 1))
        return cls(
            indices=torch.stack(idx), slots=torch.stack(slt),
            blocks=torch.stack(blk), flat_rows=torch.stack(fr),
            flat_cols=torch.stack(fc), shape=tuple(int(s) for s in shape),
            blocking=planes[0].blocking,
            plane_nnz=tuple(int(p.nnz_blocks) for p in planes),
        )

    @property
    def num_planes(self) -> int:
        return self.indices.shape[0]

    @property
    def grid_k(self) -> int:
        return -(-self.shape[-2] // self.blocking.bk)

    @property
    def grid_n(self) -> int:
        return self.indices.shape[1]

    @property
    def max_nnz(self) -> int:
        return self.indices.shape[2]

    @property
    def nnz_blocks(self) -> int:
        return sum(self.plane_nnz)

    @property
    def planes(self) -> Tuple[BSRWeight, ...]:
        """Per-plane ``BSRWeight`` views into the fused arrays."""
        kn = (int(self.shape[-2]), int(self.shape[-1]))
        return tuple(
            BSRWeight(indices=self.indices[e], slots=self.slots[e],
                      blocks=self.blocks[e], flat_rows=self.flat_rows[e],
                      flat_cols=self.flat_cols[e], shape=kn,
                      blocking=self.blocking, nnz_blocks=self.plane_nnz[e])
            for e in range(self.num_planes))

    def density(self) -> float:
        return self.nnz_blocks / max(
            self.num_planes * self.grid_k * self.grid_n, 1)


@torch.no_grad()
def pack_bsr(
    weight: torch.Tensor,
    blocking: BlockingSpec,
    mask: Optional[torch.Tensor] = None,
    *,
    min_slots: int = 1,
) -> BSRWeight:
    """Pack a masked dense (K, N) weight into BSR, on its own device."""
    w = weight
    if w.ndim != 2:
        raise ValueError(f"pack_bsr expects 2-D weights, got {tuple(w.shape)}")
    if mask is not None:
        w = w * mask.to(device=w.device, dtype=w.dtype)
    k, n = w.shape
    bk, bn = min(blocking.bk, k), min(blocking.bn, n)
    gk, gn = -(-k // bk), -(-n // bn)
    wp = torch.zeros((gk * bk, gn * bn), dtype=w.dtype, device=w.device)
    wp[:k, :n] = w
    tiles = wp.reshape(gk, bk, gn, bn).permute(0, 2, 1, 3)   # (gk, gn, bk, bn)
    # a tile lives if any entry is nonzero (a NaN tile, like the
    # reference's NaN-sum > 0 test, counts as dead)
    alive = tiles.abs().amax(dim=(2, 3)) > 0                 # (gk, gn)

    per_col = alive.sum(dim=0)                               # (gn,)
    counts = per_col.tolist()
    max_nnz = max(max(counts, default=0), min_slots)
    nnz = int(sum(counts))
    # column-major: nonzero over alive.T is sorted by column, then row
    cols, rows = torch.nonzero(alive.T, as_tuple=True)
    dev = w.device
    if nnz:
        blocks = tiles[rows, cols].contiguous()
        flat_rows = rows.to(torch.int32)
        flat_cols = cols.to(torch.int32)
    else:
        blocks = torch.zeros((1, bk, bn), dtype=w.dtype, device=dev)
        flat_rows = torch.zeros((1,), dtype=torch.int32, device=dev)
        flat_cols = torch.zeros((1,), dtype=torch.int32, device=dev)
    indices = torch.full((gn, max_nnz), -1, dtype=torch.int32, device=dev)
    slots = torch.zeros((gn, max_nnz), dtype=torch.int32, device=dev)
    if nnz:
        start = torch.cumsum(per_col, 0) - per_col           # first slot / col
        z = torch.arange(nnz, device=dev)
        pos = z - start[cols]                                # slot within col
        indices[cols, pos] = rows.to(torch.int32)
        slots[cols, pos] = z.to(torch.int32)

    eff = BlockingSpec(bk=bk, bn=bn, consecutive=blocking.consecutive)
    return BSRWeight(
        indices=indices, slots=slots, blocks=blocks,
        flat_rows=flat_rows, flat_cols=flat_cols,
        shape=(int(k), int(n)), blocking=eff, nnz_blocks=nnz,
    )


def bsr_to_dense(bsr: BSRWeight) -> torch.Tensor:
    """Reconstruct the masked dense (K, N) weight — the test oracle."""
    bk, bn = bsr.blocking.bk, bsr.blocking.bn
    gk, gn = bsr.grid_k, bsr.grid_n
    dense = torch.zeros((gk, gn, bk, bn), dtype=bsr.blocks.dtype,
                        device=bsr.blocks.device)
    z = bsr.nnz_blocks
    dense[bsr.flat_rows[:z].long(), bsr.flat_cols[:z].long()] = bsr.blocks[:z]
    dense = dense.permute(0, 2, 1, 3).reshape(gk * bk, gn * bn)
    return dense[: bsr.shape[0], : bsr.shape[1]]
