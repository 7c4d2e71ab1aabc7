"""Block-sparse (BSR) matmuls: the Hopper kernels' wrappers and their
plain PyTorch versions.

Replaces ``bsr_matmul_kernel`` / ``bsr_matmul_pallas`` and
``bsr_planes_matmul_kernel`` / ``bsr_planes_matmul_pallas``
(``src/repro/kernels/block_sparse_matmul.py:77,109,178,216``).  Each
computes ``y = act(x @ W_bsr + bias) * mult + residual`` with fp32
accumulation and returns ``x.dtype``; the planes variant does so for
every plane ``e`` of ``x (E, M, K)`` against its own BSR weight in one
launch, with the bias shared across planes:

* ``bsr_matmul_cuda`` launches ``csrc/bsr_matmul.cu`` (body
  ``csrc/bsr_split.cuh``) on CUDA tensors, with the slot-group partition
  and the row tile chosen here (``bsr_slot_groups``, ``bsr_row_tile``);
* ``bsr_planes_matmul_cuda`` launches ``csrc/bsr_planes_matmul.cu``
  (the same body, the plane on a grid axis), with the row tile and the
  slot groups chosen here (``bsr_planes_grid``);
* ``bsr_matmul_plain`` / ``bsr_planes_matmul_plain`` follow
  ``src/repro/kernels/ref.py:43,66``: one batched GEMM over the live
  tiles of the flat store(s), then ``index_add_`` over the output
  block-columns (offset by ``e * grid_n`` per plane).  They never
  densify the weight.

Row counts (planes only).  The rows of a plane are ``S`` segments of
``C = M // S`` rows (the (group, expert) segments of the MoE capacity
buffer); ``row_counts`` (E, S) int32 gives the live leading rows of each
segment.  Rows at or past their segment's count are taken as zero rows
of x: the kernel loads no weight tile and multiplies nothing for them
and writes ``epilogue(0)`` there (bias, activation, multiplier and
residual as usual); a plane whose counts are all 0 reads no tile.  The
plain version zeroes those rows of x before its product: it is the
oracle of the contract.  ``row_counts=None`` takes every row as live.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.packing import BSRPlanes, BSRWeight
from . import _build
from .epilogue import Epilogue, apply_epilogue

__all__ = ["bsr_matmul_plain", "bsr_matmul_cuda", "bsr_planes_matmul_plain",
           "bsr_planes_matmul_cuda", "bsr_slot_groups", "bsr_row_tile",
           "bsr_grid", "bsr_planes_row_tile", "bsr_planes_grid",
           "live_rows", "ACT_CODES"]

# activation codes of csrc/bsr_split.cuh
ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3, "sigmoid": 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/bsr_split.cuh: output columns per CTA, slot groups per cluster (the
# portable cluster size) and slots per group held in shared memory
BSR_STRIPE = 32
BSR_MAX_GROUPS = 8
BSR_MAX_GROUP_SLOTS = 1024
H100_SMS = 132            # streaming multiprocessors of an H100 SXM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bsr_slot_groups(grid_n: int, max_nnz: int, bn: int,
                    planes: int = 1) -> Tuple[int, int]:
    """(slots per group, groups): the fixed cut of every block column's
    ``max_nnz`` slots into consecutive groups, one CTA each, whose partial
    sums the kernel adds in group order.

    It depends on the weight's layout alone (``grid_n``, ``max_nnz``, the
    stripe count from ``bn`` and, for a stack, the number of ``planes``),
    never on M, the row tile or the row counts, so a row's sum has the
    same order in every call.  Groups are made small enough that
    ``planes * grid_n * stripes * groups`` reaches one CTA per SM of an
    H100 where the slots allow it, and at most ``BSR_MAX_GROUPS`` (one
    cluster).  At granite's expert stacks (32 planes) one group already
    gives 512 or 1024 CTAs per row tile."""
    ctas = planes * grid_n * _cdiv(bn, BSR_STRIPE)
    want = _cdiv(H100_SMS, ctas)
    per = max(min(max_nnz // want, BSR_MAX_GROUP_SLOTS),
              _cdiv(max_nnz, BSR_MAX_GROUPS), 1)
    return per, _cdiv(max_nnz, per)


def bsr_row_tile(m: int, dtype: torch.dtype) -> int:
    """Rows per CTA.  fp32: 4 or 8 at decode sizes, 16 up to 48 rows (the
    engine's prompt tails; more CTAs, each with less FFMA work, measured
    faster there than one 64-row tile), 64 beyond.  bf16: one mma m16
    tile up to 16 rows, 64 beyond."""
    if dtype == torch.float32:
        return 4 if m <= 4 else 8 if m <= 8 else 16 if m <= 48 else 64
    return 16 if m <= 16 else 64


def bsr_grid(m: int, bsr: BSRWeight, dtype: torch.dtype):
    """The 2-D kernel's launch geometry for x (m, K): ((block columns x
    stripes, groups, row tiles), slots per group, row tile)."""
    per, groups = bsr_slot_groups(bsr.grid_n, bsr.max_nnz, bsr.blocking.bn)
    bm = bsr_row_tile(m, dtype)
    grid = (bsr.grid_n * _cdiv(bsr.blocking.bn, BSR_STRIPE), groups,
            _cdiv(m, bm))
    return grid, per, bm


def bsr_planes_row_tile(c: int, dtype: torch.dtype) -> int:
    """Rows per CTA of the planes kernel, from the segment length ``C``
    (the capacity) and the dtype, never from M or the counts: fp32 4 or 8
    for decode buffers, 16 up to 48 rows (prompt tails), 64 beyond; bf16
    one mma m16 tile up to 48 rows, 64 beyond.  A tile never straddles
    two segments."""
    if dtype == torch.float32:
        return bsr_row_tile(c, dtype)
    return 16 if c <= 48 else 64


def bsr_planes_grid(m: int, segs: int, planes: BSRPlanes, dtype: torch.dtype):
    """The planes kernel's launch geometry for x (E, m, K) cut into
    ``segs`` row segments: ((block columns x stripes, groups,
    E x segs x row tiles per segment), slots per group, row tile)."""
    e = planes.num_planes
    per, groups = bsr_slot_groups(planes.grid_n, planes.max_nnz,
                                  planes.blocking.bn, planes=e)
    bm = bsr_planes_row_tile(m // segs, dtype)
    grid = (planes.grid_n * _cdiv(planes.blocking.bn, BSR_STRIPE), groups,
            e * segs * _cdiv(m // segs, bm))
    return grid, per, bm


def live_rows(row_counts: torch.Tensor, m: int) -> torch.Tensor:
    """(E, m) bool: row r of plane e is live iff ``r % C <
    row_counts[e, r // C]``, C = m // S, for counts (E, S)."""
    e, segs = row_counts.shape
    c = m // segs
    r = torch.arange(c, device=row_counts.device)
    return (r[None, None, :] < row_counts[:, :, None]).reshape(e, segs * c)


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


def bsr_planes_matmul_plain(x: torch.Tensor, planes: BSRPlanes, *,
                            epilogue: Optional[Epilogue] = None,
                            row_counts: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """y[e] = epilogue(x[e] @ W_bsr[e]) for x (E, M, K) -> (E, M, n):
    one batched GEMM over every plane's flat store, one ``index_add_``
    over segment ids offset by ``e * grid_n``.  A dead plane contributes
    only its zero padding blocks.  With ``row_counts`` (E, S), rows past
    their segment's count are zeroed first (the module's row-count
    contract)."""
    e, m, k = x.shape
    if row_counts is not None:
        _check_counts("bsr_planes_matmul_plain", row_counts, e, m, x.device)
        x = torch.where(live_rows(row_counts, m)[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    bk, bn = planes.blocking.bk, planes.blocking.bn
    gn, z = planes.grid_n, planes.blocks.shape[1]
    pad = (-k) % bk
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    xt = xp.reshape(e, m, -1, bk).transpose(1, 2)               # (E, gk, M, bk)
    plane = torch.arange(e, device=x.device)
    xg = xt[plane[:, None], planes.flat_rows.long()]            # (E, Z, M, bk)
    contrib = torch.matmul(xg.to(torch.float32),
                           planes.blocks.to(torch.float32))     # (E, Z, M, bn)
    segs = (planes.flat_cols.long() + plane[:, None] * gn).reshape(-1)
    y = torch.zeros((e * gn, m, bn), dtype=torch.float32, device=x.device)
    y.index_add_(0, segs, contrib.reshape(e * z, m, bn))
    y = y.reshape(e, gn, m, bn).transpose(1, 2).reshape(e, m, gn * bn)
    return apply_epilogue(y[:, :, : planes.shape[-1]], epilogue).to(x.dtype)


def _check_counts(name: str, row_counts: torch.Tensor, e: int, m: int,
                  device) -> None:
    """Counts (E, S) int32 on x's device, S dividing M."""
    if row_counts.ndim != 2 or row_counts.shape[0] != e \
            or row_counts.shape[1] < 1 or m % row_counts.shape[1]:
        raise ValueError(f"{name}: row_counts {tuple(row_counts.shape)} must "
                         f"be (E={e}, S) with S dividing M={m}")
    if row_counts.dtype != torch.int32 or row_counts.device != device:
        raise TypeError(f"{name}: row_counts must be int32 on {device}, got "
                        f"{row_counts.dtype} on {row_counts.device}")


_FNS = {}


def _launcher(name: str, n_ptrs: int, n_ints: int):
    """The C entry point ``<name>_launch(dtype, n_ptrs pointers, n_ints
    ints, stream)`` of kernel ``name``."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.library(name), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        _FNS[name] = fn
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_operands(name: str, x: torch.Tensor, w) -> None:
    """x on the card in the weight's dtype; the weight's arrays
    contiguous int32 maps and flat store on x's device."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES or w.blocks.dtype != x.dtype:
        raise TypeError(f"{name}: x {x.dtype} and blocks {w.blocks.dtype} "
                        "must be one of float32/bfloat16")
    for field, t in (("blocks", w.blocks), ("indices", w.indices),
                     ("slots", w.slots)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {field} must be contiguous on {x.device}")
    if w.indices.dtype != torch.int32 or w.slots.dtype != torch.int32:
        raise TypeError(f"{name}: indices/slots must be int32")


def _epilogue_operands(name: str, epilogue: Optional[Epilogue], x: torch.Tensor,
                       out_shape):
    """(bias fp32 (N,), multiplier, residual, activation code); the
    multiplier and residual must be contiguous, output-shaped, in x's
    dtype and on its device."""
    epi = epilogue or Epilogue()
    bias = None
    if epi.bias is not None:
        bias = epi.bias.to(device=x.device, dtype=torch.float32).contiguous()
        if bias.shape != out_shape[-1:]:
            raise ValueError(f"bias {tuple(bias.shape)} != ({out_shape[-1]},)")
    for field, t in (("multiplier", epi.multiplier), ("residual", epi.residual)):
        if t is None:
            continue
        if tuple(t.shape) != tuple(out_shape) or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: {field} must be contiguous {tuple(out_shape)} "
                f"{x.dtype} on {x.device}, got {tuple(t.shape)} {t.dtype}")
    return bias, epi.multiplier, epi.residual, ACT_CODES[epi.activation]


def bsr_matmul_cuda(x: torch.Tensor, bsr: BSRWeight, *,
                    epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """Launch the Hopper BSR kernel: x (M, K) on the card, same dtype as
    the weight's blocks (fp32 or bf16); multiplier/residual (M, N) in that
    dtype too.  Returns (M, N) in x.dtype."""
    if x.ndim != 2:
        raise ValueError(f"bsr_matmul_cuda needs a 2-D tensor, got "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    kk, n = bsr.shape
    if k != kk:
        raise ValueError(f"x has K={k}, weight has K={kk}")
    _check_operands("bsr_matmul_cuda", x, bsr)
    bias, mult, res, act = _epilogue_operands("bsr_matmul_cuda", epilogue, x,
                                              (m, n))
    x = x.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    (_, groups, _), per, bm = bsr_grid(m, bsr, x.dtype)
    if per > BSR_MAX_GROUP_SLOTS:
        raise ValueError(f"bsr_matmul_cuda: max_nnz {bsr.max_nnz} > "
                         f"{BSR_MAX_GROUPS * BSR_MAX_GROUP_SLOTS}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher("bsr_matmul", 8, 11)(
            _DTYPE_CODES[x.dtype], x.data_ptr(), bsr.blocks.data_ptr(),
            bsr.indices.data_ptr(), bsr.slots.data_ptr(), _ptr(bias),
            _ptr(mult), _ptr(res), out.data_ptr(), m, k, n,
            bsr.blocking.bk, bsr.blocking.bn, bsr.grid_n, bsr.max_nnz, bm,
            groups, per, act, stream)
    _build.check("bsr_matmul", err)
    _build.launch_counts["bsr_matmul"] += 1
    return out


def bsr_planes_matmul_cuda(x: torch.Tensor, planes: BSRPlanes, *,
                           epilogue: Optional[Epilogue] = None,
                           row_counts: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Launch the Hopper planes kernel once for the whole stack: x
    (E, M, K) on the card, same dtype as the blocks (fp32 or bf16);
    multiplier/residual (E, M, N) in that dtype, bias (N,) shared by the
    planes; ``row_counts`` (E, S) int32 or None (every row live).
    Returns (E, M, N) in x.dtype."""
    name = "bsr_planes_matmul_cuda"
    if x.ndim != 3:
        raise ValueError(f"{name} needs a 3-D tensor, got {tuple(x.shape)}")
    e, m, k = x.shape
    kk, n = planes.shape[-2], planes.shape[-1]
    if k != kk or e != planes.num_planes:
        raise ValueError(f"x is {tuple(x.shape)}, weight has "
                         f"{planes.num_planes} planes of K={kk}")
    _check_operands(name, x, planes)
    bias, mult, res, act = _epilogue_operands(name, epilogue, x, (e, m, n))
    segs = 1
    if row_counts is not None:
        _check_counts(name, row_counts, e, m, x.device)
        segs = row_counts.shape[1]
        row_counts = row_counts.contiguous()
    x = x.contiguous()
    out = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if m == 0 or e == 0:
        return out
    (_, groups, z), per, bm = bsr_planes_grid(m, segs, planes, x.dtype)
    if per > BSR_MAX_GROUP_SLOTS or z > 65535:
        raise ValueError(f"{name}: max_nnz {planes.max_nnz} or {z} "
                         "plane x row tiles past the kernel's limits")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher("bsr_planes_matmul", 9, 14)(
            _DTYPE_CODES[x.dtype], x.data_ptr(), planes.blocks.data_ptr(),
            planes.indices.data_ptr(), planes.slots.data_ptr(), _ptr(bias),
            _ptr(mult), _ptr(res), out.data_ptr(), _ptr(row_counts), e, m, k,
            n, planes.blocking.bk, planes.blocking.bn, planes.grid_n,
            planes.max_nnz, planes.blocks.shape[1], segs, bm, groups, per,
            act, stream)
    _build.check("bsr_planes_matmul", err)
    _build.launch_counts["bsr_planes_matmul"] += 1
    return out
