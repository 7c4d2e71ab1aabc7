"""Fused paged attention: the Hopper kernels' wrappers and their plain
PyTorch versions.

Replaces ``_decode_kernel`` / ``paged_attention_decode_pallas`` and
``_prefill_kernel`` / ``paged_attention_prefill_pallas``
(``src/repro/kernels/paged_attention.py:146,193,324,380``).  The KV pool
is ``(num_pages, page_size, K, dh)`` shared by all sequences; a row's
logical position ``t`` lives at ``pool[table[t // ps], t % ps]``.  Both
kernels walk the table with an fp32 online softmax instead of gathering
a logical view; masked positions get the finite ``NEG_INF`` score and a
zeroed V, so NaN in unallocated pages never leaks through ``0 * NaN``.

* ``*_cuda`` launch ``csrc/paged_decode.cu`` / ``csrc/paged_prefill.cu``.
  The decode kernel cuts a row's context into chunks of
  ``decode_chunk(ps, dh)`` positions; chunk ``c`` belongs to virtual rank
  ``c % 8``, and the seed and the 8 virtual ranks' states are merged in
  rank order in the same launch through a thread-block cluster of
  ``decode_grid(...)[0]`` CTAs per (row, KV head).  A row's result
  depends on its own length and pages only, not on B or the table width.
* ``*_plain`` follow the reference's page-segment walks
  (``paged_attention.py:76,258``): the same recurrence, ``pages_per_step``
  pages at a time.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "NEG_INF",
    "paged_attention_decode_plain",
    "paged_attention_decode_cuda",
    "paged_attention_prefill_plain",
    "paged_attention_prefill_cuda",
    "prefill_grid",
    "decode_chunk",
    "decode_grid",
]

NEG_INF = -1e30  # finite mask sentinel (matches models/attention.py)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/paged_prefill.cu: query rows (position, head) per CTA, and the
# head dims it is built for
PREFILL_ROWS = 16
PREFILL_HEAD_DIMS = (64, 128)
# csrc/paged_decode.cu: the head dims it is built for, positions a chunk
# aims at, and the virtual ranks (= the largest cluster) chunks cycle over
DECODE_HEAD_DIMS = (64, 128)
DECODE_CHUNK = 32
DECODE_RANKS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def prefill_grid(b: int, s: int, h: int, kvh: int):
    """The prefill kernel's grid: one CTA per (row, KV head, tile of
    ``PREFILL_ROWS`` query rows of the GQA group)."""
    return b, kvh, _cdiv(s * (h // kvh), PREFILL_ROWS)


def decode_chunk(ps: int, dh: int) -> int:
    """Positions per decode chunk: the smallest multiple of the page size
    ``ps`` that holds ``DECODE_CHUNK`` positions (32 at ps 4, 8, 16; ps
    itself for pages past 32).  Fixed by (ps, dh) alone; the kernel's
    shared memory holds two chunks of K and V."""
    if dh not in DECODE_HEAD_DIMS:
        raise ValueError(f"paged decode: head_dim {dh} not one of "
                         f"{DECODE_HEAD_DIMS}")
    return ps * _cdiv(DECODE_CHUNK, ps)


def decode_grid(b: int, kvh: int, ps: int, dh: int, max_pages: int):
    """The decode kernel's grid (R, KV heads, rows): the R CTAs of a
    (row, KV head) are one cluster, R = min(8, chunks of the table), from
    the table width and not from the lengths (no host sync).  R decides
    only which CTA computes a virtual rank, never the arithmetic."""
    table_chunks = _cdiv(max_pages * ps, decode_chunk(ps, dh))
    return min(DECODE_RANKS, max(1, table_chunks)), kvh, b


def _rows(v: torch.Tensor, b: int) -> torch.Tensor:
    """A scalar or (B,) length as a (B,) int64 tensor."""
    return torch.as_tensor(v).reshape(-1).expand(b).to(torch.int64)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def paged_attention_decode_plain(q, k_new, v_new, k_pool, v_pool, page_table,
                                 cache_len, *, pages_per_step: int = 8):
    """q (B, H, dh) attends over [0, cache_len) of its pages plus the new
    token (k_new/v_new (B, K, dh)), which seeds the state.  (B, H, dh)
    fp32."""
    b, h, dh = q.shape
    kvh = k_new.shape[1]
    g = h // kvh
    ps = k_pool.shape[1]
    max_pages = page_table.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kvh, g, dh).to(torch.float32)
    kn = k_new.to(torch.float32)
    vn = v_new.to(torch.float32)
    clen = _rows(cache_len, b).to(dev)
    table = page_table.long()

    s_new = torch.sum(qg * kn[:, :, None, :], dim=-1, keepdim=True) * scale
    m = s_new                                              # (B, K, G, 1)
    l = torch.ones_like(s_new)
    acc = vn[:, :, None, :].expand(b, kvh, g, dh).clone()

    seg = pages_per_step * ps
    offs = torch.arange(ps, device=dev)
    page_idx = torch.arange(pages_per_step, device=dev)
    # the whole table, not the longest row's pages: a step past every
    # row's length changes nothing (r = 1, p = 0), and the step count
    # needs no read of the lengths on the host
    for j in range(_cdiv(max_pages, pages_per_step) if b else 0):
        idx = j * pages_per_step + page_idx                # logical pages
        pid = table[:, idx.clamp(max=max_pages - 1)]       # (B, pps)
        kp = k_pool[pid].reshape(b, seg, kvh, dh).to(torch.float32)
        vp = v_pool[pid].reshape(b, seg, kvh, dh).to(torch.float32)
        pos = (idx[:, None] * ps + offs[None, :]).reshape(seg)
        valid = (pos[None, :] < clen[:, None]) & (pos[None, :] < max_pages * ps)
        s = torch.einsum("bkgd,bskd->bkgs", qg, kp) * scale
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
        vp = vp.masked_fill(~valid[:, :, None, None], 0.0)
        m2 = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        r = torch.exp(m - m2)
        p = torch.exp(s - m2).masked_fill(~valid[:, None, None, :], 0.0)
        l = l * r + p.sum(dim=-1, keepdim=True)
        acc = acc * r + torch.einsum("bkgs,bskd->bkgd", p, vp)
        m = m2
    return (acc / l).reshape(b, h, dh)


_FNS = {}


def _launcher(name: str, symbol: str, n_ptr: int, n_int: int):
    """The C entry point: two dtype codes, ``n_ptr`` pointers, ``n_int``
    ints, the softmax scale and the stream."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        _FNS[name] = fn
    return fn


def _check_common(name, q, k_pool, v_pool, page_table, lengths, kvh, dh):
    dev = q.device
    if not q.is_cuda:
        raise ValueError(f"{name}: needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: q dtype {q.dtype} not float32/bfloat16")
    if k_pool.dtype not in _DTYPE_CODES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{name}: pools {k_pool.dtype}/{v_pool.dtype} must "
                        "share float32 or bfloat16")
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[2:] != (kvh, dh):
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} != (P, ps, {kvh}, {dh})")
    for t in (k_pool, v_pool, page_table, lengths):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be contiguous on {dev}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and lengths must be int32")


def paged_attention_decode_cuda(q, k_new, v_new, k_pool, v_pool, page_table,
                                cache_len):
    """Launch the Hopper decode kernel, once.  q (B, H, dh), k_new/v_new
    (B, K, dh) in q's dtype, pools (P, ps, K, dh), page_table
    (B, max_pages) int32, cache_len (B,) int32; dh 64 or 128.
    (B, H, dh) fp32."""
    name = "paged_attention_decode"
    b, h, dh = q.shape
    kvh = k_new.shape[1]
    _check_common(name, q, k_pool, v_pool, page_table, cache_len, kvh, dh)
    if h % kvh or k_new.shape != (b, kvh, dh) or v_new.shape != k_new.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k_new "
                         f"{tuple(k_new.shape)} v_new {tuple(v_new.shape)}")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError(f"{name}: k_new/v_new must have q's dtype {q.dtype}")
    if page_table.shape[0] != b or cache_len.shape != (b,):
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} / "
                         f"cache_len {tuple(cache_len.shape)} vs B={b}")
    ps, max_pages = k_pool.shape[1], page_table.shape[1]
    chunk = decode_chunk(ps, dh)
    ranks = decode_grid(b, kvh, ps, dh, max_pages)[0]
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(name, "paged_decode_launch", 8, 8)(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(),
            b, h, kvh, dh, ps, max_pages, chunk, ranks,
            1.0 / math.sqrt(dh), stream)
    _build.check(name, err)
    _build.launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def paged_attention_prefill_plain(q, k_pool, v_pool, page_table, lengths, *,
                                  pages_per_step: int = 8, q_offset: int = 0):
    """Causal attention for q (B, S, H, dh) at logical positions
    [q_offset, q_offset+S) over each row's pages from position 0;
    ``lengths`` (B,) is the total context.  Rows at or past their length
    give 0.  (B, S, H, dh) fp32."""
    b, s, h, dh = q.shape
    kvh = k_pool.shape[2]
    g = h // kvh
    ps = k_pool.shape[1]
    max_pages = page_table.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, s, kvh, g, dh).permute(0, 2, 3, 1, 4).to(torch.float32)
    ln = _rows(lengths, b).to(dev)
    table = page_table.long()

    m = torch.full((b, kvh, g, s, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, s, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, s, dh), dtype=torch.float32, device=dev)
    qpos = q_offset + torch.arange(s, device=dev)
    seg = pages_per_step * ps
    offs = torch.arange(ps, device=dev)
    page_idx = torch.arange(pages_per_step, device=dev)

    for j in range(_cdiv(_cdiv(q_offset + s, ps), pages_per_step)):
        idx = j * pages_per_step + page_idx
        pid = table[:, idx.clamp(max=max_pages - 1)]
        kp = k_pool[pid].reshape(b, seg, kvh, dh).to(torch.float32)
        vp = v_pool[pid].reshape(b, seg, kvh, dh).to(torch.float32)
        kvpos = (idx[:, None] * ps + offs[None, :]).reshape(seg)
        valid = ((kvpos[None, None, :] <= qpos[None, :, None])
                 & (kvpos[None, None, :] < ln[:, None, None])
                 & (qpos[None, :, None] < ln[:, None, None]))    # (B, S, seg)
        kv_live = kvpos[None, :] < ln[:, None]                  # (B, seg)
        sb = torch.einsum("bkgqd,bskd->bkgqs", qg, kp) * scale
        sb = sb.masked_fill(~valid[:, None, None], NEG_INF)
        vp = vp.masked_fill(~kv_live[:, :, None, None], 0.0)
        m2 = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        r = torch.exp(m - m2)
        p = torch.exp(sb - m2).masked_fill(~valid[:, None, None], 0.0)
        l = l * r + p.sum(dim=-1, keepdim=True)
        acc = acc * r + torch.einsum("bkgqs,bskd->bkgqd", p, vp)
        m = m2
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)   # dead rows -> 0
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


def paged_attention_prefill_cuda(q, k_pool, v_pool, page_table, lengths, *,
                                 q_offset: int = 0):
    """Launch the Hopper prefill kernel.  q (B, S, H, dh), pools
    (P, ps, K, dh), page_table (B, max_pages) int32, lengths (B,) int32
    total context per row.  (B, S, H, dh) fp32."""
    name = "paged_attention_prefill"
    b, s, h, dh = q.shape
    kvh = k_pool.shape[2]
    _check_common(name, q, k_pool, v_pool, page_table, lengths, kvh, dh)
    if h % kvh:
        raise ValueError(f"{name}: {h} heads not a multiple of {kvh} KV heads")
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} / "
                         f"lengths {tuple(lengths.shape)} vs B={b}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} < 0")
    if dh not in PREFILL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not one of {PREFILL_HEAD_DIMS}")
    q = q.contiguous()
    out = torch.empty((b, s, h, dh), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(name, "paged_prefill_launch", 6, 9)(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, s, h, kvh, dh, k_pool.shape[1], page_table.shape[1],
            int(q_offset), PREFILL_ROWS, 1.0 / math.sqrt(dh), stream)
    _build.check(name, err)
    _build.launch_counts[name] += 1
    return out
