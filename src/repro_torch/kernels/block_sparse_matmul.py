"""Block-sparse (BSR) matmul: the Hopper kernel's wrapper and its plain
PyTorch version.

Replaces ``bsr_matmul_kernel`` / ``bsr_matmul_pallas``
(``src/repro/kernels/block_sparse_matmul.py:77,109``).  Both functions
compute ``y = act(x @ W_bsr + bias) * mult + residual`` for ``x (M, K)``
with fp32 accumulation and return ``x.dtype``:

* ``bsr_matmul_cuda`` launches ``csrc/bsr_matmul.cu`` on CUDA tensors;
* ``bsr_matmul_plain`` follows ``src/repro/kernels/ref.py:43``: one
  batched GEMM over the live tiles of the flat store, then ``index_add_``
  over the output block-columns.  It never densifies the weight.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.packing import BSRWeight
from . import _build
from .epilogue import Epilogue, apply_epilogue

__all__ = ["bsr_matmul_plain", "bsr_matmul_cuda", "ACT_CODES"]

# activation codes of csrc/bsr_matmul.cu
ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3, "sigmoid": 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bsr_matmul_plain(x: torch.Tensor, bsr: BSRWeight, *,
                     epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """y = epilogue(x @ W_bsr) contracting the flat live-tile store only.
    Products of the operands are exact in fp32 (bf16 inputs are widened
    first), so the sums are fp32 as on the kernel and the reference."""
    bk, bn = bsr.blocking.bk, bsr.blocking.bn
    gn = bsr.grid_n
    m, k = x.shape
    pad = (-k) % bk
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    xt = xp.reshape(m, -1, bk).transpose(0, 1)                  # (gk, M, bk)
    xg = xt[bsr.flat_rows.long()].to(torch.float32)             # (Z, M, bk)
    contrib = torch.bmm(xg, bsr.blocks.to(torch.float32))       # (Z, M, bn)
    y = torch.zeros((gn, m, bn), dtype=torch.float32, device=x.device)
    y.index_add_(0, bsr.flat_cols.long(), contrib)              # (gn, M, bn)
    y = y.transpose(0, 1).reshape(m, gn * bn)[:, : bsr.shape[1]]
    return apply_epilogue(y, epilogue).to(x.dtype)


_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.library("bsr_matmul").bsr_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        _FN = fn
    return _FN


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def bsr_matmul_cuda(x: torch.Tensor, bsr: BSRWeight, *,
                    epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """Launch the Hopper BSR kernel: x (M, K) on the card, same dtype as
    the weight's blocks (fp32 or bf16); multiplier/residual (M, N) in that
    dtype too.  Returns (M, N) in x.dtype."""
    if x.ndim != 2 or not x.is_cuda:
        raise ValueError(f"bsr_matmul_cuda needs a 2-D CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    m, k = x.shape
    kk, n = bsr.shape
    if k != kk:
        raise ValueError(f"x has K={k}, weight has K={kk}")
    if x.dtype not in _DTYPE_CODES or bsr.blocks.dtype != x.dtype:
        raise TypeError(f"bsr_matmul_cuda: x {x.dtype} and blocks "
                        f"{bsr.blocks.dtype} must be one of float32/bfloat16")
    for name, t in (("blocks", bsr.blocks), ("indices", bsr.indices),
                    ("slots", bsr.slots)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"bsr_matmul_cuda: {name} must be contiguous "
                             f"on {x.device}")
    if bsr.indices.dtype != torch.int32 or bsr.slots.dtype != torch.int32:
        raise TypeError("bsr_matmul_cuda: indices/slots must be int32")
    epi = epilogue or Epilogue()
    bias = mult = res = None
    if epi.bias is not None:
        bias = epi.bias.to(device=x.device, dtype=torch.float32).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"bias {tuple(bias.shape)} != ({n},)")
    for name, t in (("multiplier", epi.multiplier), ("residual", epi.residual)):
        if t is None:
            continue
        if t.shape != (m, n) or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(
                f"bsr_matmul_cuda: {name} must be contiguous ({m}, {n}) "
                f"{x.dtype} on {x.device}, got {tuple(t.shape)} {t.dtype}")
    mult, res = epi.multiplier, epi.residual
    x = x.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(
            _DTYPE_CODES[x.dtype], x.data_ptr(), bsr.blocks.data_ptr(),
            bsr.indices.data_ptr(), bsr.slots.data_ptr(), _ptr(bias),
            _ptr(mult), _ptr(res), out.data_ptr(), m, k, n,
            bsr.blocking.bk, bsr.blocking.bn, bsr.grid_n, bsr.max_nnz,
            ACT_CODES[epi.activation], stream)
    _build.check("bsr_matmul", err)
    _build.launch_counts["bsr_matmul"] += 1
    return out
