"""Per-tile L2 norms: the Hopper kernel's wrapper and its plain PyTorch
version.

Replaces ``structure_norms_kernel`` / ``structure_norms_pallas``
(``src/repro/kernels/structure_norms.py:20,25``).  Both return the fp32
L2 norm of every ``(bk, bn)`` tile of a ``(K, N)`` weight as
``(grid_k, grid_n)``, tail tiles zero-padded; ``bk``/``bn`` clamp to the
weight's dims:

* ``structure_norms_cuda`` launches ``csrc/structure_norms.cu``;
* ``structure_norms_plain`` follows ``src/repro/kernels/ref.py:98``.

As in the reference, no path of the port calls it: ``knapsack_prune``
uses ``core.structures.structure_norms_dense`` over whole (planes, K, N)
weights.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["structure_norms_plain", "structure_norms_cuda"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _tile_grid(k: int, n: int, bk: int, bn: int) -> Tuple[int, int, int, int]:
    """(bk, bn, grid_k, grid_n) with the tile clamped to the weight."""
    bk, bn = min(bk, k), min(bn, n)
    return bk, bn, -(-k // bk), -(-n // bn)


def structure_norms_plain(w: torch.Tensor, bk: int = 128,
                          bn: int = 128) -> torch.Tensor:
    k, n = w.shape
    bk, bn, gk, gn = _tile_grid(k, n, bk, bn)
    wp = torch.nn.functional.pad(w.to(torch.float32),
                                 (0, gn * bn - n, 0, gk * bk - k))
    t = wp.reshape(gk, bk, gn, bn)
    return torch.sqrt(torch.sum(torch.square(t), dim=(1, 3)))


_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.library("structure_norms").structure_norms_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        _FN = fn
    return _FN


def structure_norms_cuda(w: torch.Tensor, bk: int = 128,
                         bn: int = 128) -> torch.Tensor:
    """Launch the Hopper kernel on a 2-D fp32/bf16 CUDA weight."""
    if w.ndim != 2 or not w.is_cuda:
        raise ValueError(f"structure_norms_cuda needs a 2-D CUDA tensor, got "
                         f"{tuple(w.shape)} on {w.device}")
    if w.dtype not in _DTYPE_CODES:
        raise TypeError(f"structure_norms_cuda: {w.dtype} is not "
                        "float32/bfloat16")
    k, n = w.shape
    bk, bn, gk, gn = _tile_grid(k, n, bk, bn)
    w = w.contiguous()
    out = torch.empty((gk, gn), dtype=torch.float32, device=w.device)
    if w.numel() == 0:
        return out.zero_()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = _launcher()(_DTYPE_CODES[w.dtype], w.data_ptr(), out.data_ptr(),
                          k, n, bk, bn, stream)
    _build.check("structure_norms", err)
    _build.launch_counts["structure_norms"] += 1
    return out
