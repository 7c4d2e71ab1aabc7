"""Attention: GQA prefill and decode over contiguous or paged KV caches —
torch port of ``src/repro/models/attention.py``.

Paged caches are pools ``(num_pages, page_size, K, dh)`` shared by all
sequences.  Prefill scatters the prompt's K/V straight into the pages a
row owns and attends with the paged prefill kernel (:266-281); decode
writes the new token at page ``cache_len // ps`` (:415-424) and attends
with the paged decode kernel, the new K/V seeding its state (:434-443).
The reference updates caches functionally and donates the buffers; here
the pool and cache writes are in place (``index_put_`` / slice
assignment), which is what ``donate_argnames`` buys there.

The contiguous branches and ``chunked_causal_attention`` stay plain
torch — the reference has no kernel there either; the solo-decode check
of the serving engine runs on them.  ``attention_apply`` is the
cache-free training/eval forward (reference :128): it writes no cache,
so autograd never sees an in-place update; with ``kv_input`` it is
whisper's cross-attention.  ``cross_attention_prefill`` and
``attention_decode(update_cache=False)`` read the encoder K/V that
``encode_kv_caches`` stored in ``cross_k`` / ``cross_v`` (contiguous
caches only).  With ``mrope_sections`` q and k rotate by Qwen2-VL's
M-RoPE over (B, S, 3) positions; decode tiles its one position to the
three components, as the reference does (:407-410).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (batch_placements, is_dtensor,
                                              logical_constraint, shard_extent,
                                              shard_map, whole_groups)
from repro_torch.kernels import ops
from .layers import apply_mrope, apply_rope, dense, dense_init

__all__ = [
    "attention_init",
    "attention_apply",
    "attention_prefill",
    "attention_decode",
    "cross_attention_prefill",
    "chunked_causal_attention",
    "full_attention",
    "init_kv_cache",
]

NEG_INF = -1e30


def attention_init(d_model: int, num_heads: int, kv_heads: int, head_dim: int,
                   *, generator, device, qkv_bias: bool = False,
                   out_bias: bool = False, dtype=torch.float32) -> Dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "wq": dense_init(d_model, num_heads * head_dim, use_bias=qkv_bias, **kw),
        "wk": dense_init(d_model, kv_heads * head_dim, use_bias=qkv_bias, **kw),
        "wv": dense_init(d_model, kv_heads * head_dim, use_bias=qkv_bias, **kw),
        "wo": dense_init(num_heads * head_dim, d_model, use_bias=out_bias,
                         stddev=1.0 / math.sqrt(num_heads * head_dim), **kw),
    }


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    x = whole_groups(x, 2, heads)
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,K,G,dh), k (B,Sk,K,dh) -> (B,K,G,Sq,Sk) fp32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                        k.to(torch.float32))


def _gqa_values(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w (B,K,G,Sq,Sk) fp32, v (B,Sk,K,dh) -> (B,Sq,K,G,dh) fp32."""
    return torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))


def chunked_causal_attention(q, k, v, *, causal: bool = True,
                             window: Optional[int] = None, chunk: int = 512,
                             q_offset: int = 0) -> torch.Tensor:
    """Statically chunked attention, q (B,S,H,dh) over k/v (B,Sk,K,dh);
    query row ``i`` sits at absolute position ``q_offset + i``."""
    b, s, h, dh = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, s, kv_heads, g, dh)
    sk = k.shape[1]
    chunk = min(chunk, s)
    out = []
    for qs in range(0, s, chunk):
        qe = min(qs + chunk, s)
        abs_qs, abs_qe = qs + q_offset, qe + q_offset
        hi = min(abs_qe, sk) if causal else sk
        lo = 0 if window is None else max(0, abs_qs - window + 1)
        if hi <= lo:
            out.append(torch.zeros((b, qe - qs, kv_heads, g, dh), dtype=q.dtype,
                                   device=q.device))
            continue
        scores = _gqa_scores(qg[:, qs:qe], k[:, lo:hi]) * scale
        if causal or window is not None:
            qpos = torch.arange(abs_qs, abs_qe, device=q.device)[:, None]
            kpos = torch.arange(lo, hi, device=q.device)[None, :]
            mask = torch.ones((qe - qs, hi - lo), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            scores = scores.masked_fill(~mask, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out.append(_gqa_values(w, v[:, lo:hi]).to(q.dtype))
    return torch.cat(out, dim=1).reshape(b, s, h, dh)


def full_attention(q, k, v, *, causal=True, window=None):
    """Unchunked oracle (tests)."""
    return chunked_causal_attention(q, k, v, causal=causal, window=window,
                                    chunk=q.shape[1])


def _local_kv(k: torch.Tensor, head_off: int, heads: int, group: int) -> torch.Tensor:
    """The K/V heads (B, S, K, dh) that query heads ``[head_off, head_off +
    heads)`` read: a slice of whole groups, else one K/V head per query
    head."""
    if head_off % group == 0 and heads % group == 0:
        return k[:, :, head_off // group:(head_off + heads) // group]
    idx = (head_off + torch.arange(heads, device=k.device)) // group
    return k[:, :, idx]


def _per_head_shards(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)``, attention independent per (batch row, query
    head), run on each rank's shards when q is a DTensor: q as placed
    (heads sharded on "model" under the rules), K/V replicated over the
    heads' axes and sliced to the local query heads' groups, each ``rows``
    tensor (B, ...) sharded as q's batch.  K/V gradients are partial sums
    over the heads' axes.  Plain tensors: ``fn`` itself."""
    if not is_dtensor(q):
        return fn(q, k, v, *rows)
    from torch.distributed.tensor import Partial, Shard

    group = q.shape[2] // k.shape[2]
    head_off, heads = shard_extent(q, 2)
    batch = batch_placements(q)          # also K/V's: whole over the heads' axes
    kv_grad = tuple(Partial() if q.placements[i] == Shard(2) else batch[i]
                    for i in range(len(batch)))

    def local(ql, kl, vl, *rl):
        return fn(ql, _local_kv(kl, head_off, heads, group),
                  _local_kv(vl, head_off, heads, group), *rl)

    return shard_map(
        local, in_placements=(q.placements, batch, batch) + (batch,) * len(rows),
        out_placements=q.placements,
        in_grad_placements=(q.placements, kv_grad, kv_grad)
        + (batch,) * len(rows))(q, k, v, *rows)


def _wo_project(p: Dict, o: torch.Tensor, num_heads: int, head_dim: int,
                accum) -> torch.Tensor:
    """Output projection of (B, S, H, dh) attention values (reference
    :171): heads and head_dim contracted together, fp32 accumulation."""
    b, s = o.shape[:2]
    return dense(p["wo"], o.reshape(b, s, num_heads * head_dim), accum=accum)


def _qkv(p, x, num_heads, kv_heads, src=None):
    src = x if src is None else src
    q = _split_heads(dense(p["wq"], x), num_heads)
    k = _split_heads(dense(p["wk"], src), kv_heads)
    v = _split_heads(dense(p["wv"], src), kv_heads)
    return q, k, v


def _rotate(q, k, positions, theta, mrope_sections):
    """RoPE, or M-RoPE over (B, S, 3) positions (a (B, S) position is
    tiled to its three components)."""
    if mrope_sections is None:
        return (apply_rope(q, positions, theta=theta),
                apply_rope(k, positions, theta=theta))
    if positions.ndim == 2:
        positions = positions[..., None].expand(*positions.shape, 3)
    return (apply_mrope(q, positions, mrope_sections, theta=theta),
            apply_mrope(k, positions, mrope_sections, theta=theta))


def attention_apply(
    p: Dict,
    x: torch.Tensor,                      # (B, S, D)
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 512,
    rope_theta: float = 10000.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    kv_input: Optional[torch.Tensor] = None,   # cross-attention source
    use_rope: bool = True,
    accum=None,
) -> torch.Tensor:
    """Attention over the whole sequence with no cache (training,
    evaluation); differentiable.  ``kv_input`` (B, Sk, D) is the source
    of K and V (cross-attention), x otherwise."""
    accum = accum or torch.float32
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, num_heads, kv_heads, kv_input)
    q = logical_constraint(q, "batch", "seq", "heads", None)
    k = logical_constraint(k, "batch", "seq", "kv", None)
    v = logical_constraint(v, "batch", "seq", "kv", None)
    if use_rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q, k = _rotate(q, k, positions, rope_theta, mrope_sections)

    def attend(ql, kl, vl):
        return chunked_causal_attention(ql, kl, vl, causal=causal,
                                        window=window, chunk=chunk)

    o = logical_constraint(_per_head_shards(attend, q, k, v),
                           "batch", "seq", "heads", None)
    out = _wo_project(p, o, num_heads, head_dim, accum)
    return logical_constraint(out, "batch", "seq", "embed")


def attention_prefill(
    p: Dict,
    x: torch.Tensor,                      # (B, S, D)
    cache: Dict[str, torch.Tensor],
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    chunk: int = 512,
    rope_theta: float = 10000.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    use_rope: bool = True,
    accum=None,
    page_table: Optional[torch.Tensor] = None,   # (B, max_pages) pool ids
    start_pos: int = 0,                          # logical pos of x[:, 0]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched causal prefill that also fills the KV cache (in place).

    With ``page_table`` the cache is a pool: token ``t`` of row ``b`` goes
    to ``pool[table[b, t // ps], t % ps]`` and attention runs over the
    pages with the fused kernel.  ``start_pos > 0`` is the tail-only
    prefill of a prefix-cache hit: ``x`` holds positions
    ``[start_pos, start_pos + S)`` and the first ``start_pos`` positions
    are already in the pool."""
    accum = accum or torch.float32
    if page_table is not None and window is not None:
        raise NotImplementedError(
            "attention_prefill: sliding-window attention over a paged KV "
            f"cache is not implemented (window={window} with page_table) — "
            "SWA uses contiguous ring caches; drop the window or use a "
            "contiguous cache")
    if start_pos and page_table is None:
        raise ValueError(
            "attention_prefill: start_pos > 0 needs a page_table — the "
            "prefix lives in pool pages, a contiguous cache has no shared "
            "prefix to resume from")
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, num_heads, kv_heads)
    if use_rope:
        if positions is None:
            positions = torch.arange(start_pos, start_pos + s,
                                     device=x.device)[None].expand(b, s)
        q, k = _rotate(q, k, positions, rope_theta, mrope_sections)

    ck, cv = cache["k"], cache["v"]
    kc, vc = k.to(ck.dtype), v.to(cv.dtype)
    if page_table is not None:
        ps = ck.shape[1]
        t = torch.arange(start_pos, start_pos + s, device=x.device)
        pid = page_table[:, t // ps].long()                 # (B, S)
        off = (t % ps)[None].expand(b, s)
        ck.index_put_((pid, off), kc)
        cv.index_put_((pid, off), vc)
        total = torch.full((b,), start_pos + s, dtype=torch.int32,
                           device=x.device)
        o = ops.paged_attention_prefill(
            q, ck, cv, page_table, total, q_offset=start_pos).to(x.dtype)
    else:
        alloc = ck.shape[1]
        if s <= alloc:
            ck[:, :s] = kc
            cv[:, :s] = vc
        else:  # ring: keep the last `alloc` tokens at their decode slots
            slots = torch.arange(s - alloc, s, device=x.device) % alloc
            ck[:, slots] = kc[:, s - alloc:]
            cv[:, slots] = vc[:, s - alloc:]
        o = chunked_causal_attention(q, k, v, causal=True, window=window,
                                     chunk=chunk)
    out = _wo_project(p, o, num_heads, head_dim, accum)
    return logical_constraint(out, "batch", "seq", "embed"), cache


def cross_attention_prefill(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                            *, num_heads: int, kv_heads: int, head_dim: int,
                            chunk: int = 512) -> torch.Tensor:
    """Full-sequence cross-attention of x (B, S, D), the normed decoder
    stream, over the encoder K/V in ``cache["cross_k"]`` /
    ``cache["cross_v"]`` (reference :311): no RoPE, no mask."""
    q = _split_heads(dense(p["wq"], x), num_heads)
    o = chunked_causal_attention(
        q, cache["cross_k"].to(q.dtype), cache["cross_v"].to(q.dtype),
        causal=False, window=None, chunk=chunk)
    return _wo_project(p, o, num_heads, head_dim, torch.float32)


def init_kv_cache(batch: int, max_len: int, kv_heads: int, head_dim: int,
                  dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(
    p: Dict,
    x: torch.Tensor,                      # (B, 1, D)
    cache: Dict[str, torch.Tensor],
    cache_len,                            # scalar or (B,) int: #valid positions
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    use_rope: bool = True,
    update_cache: bool = True,
    page_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode; writes the new K/V into the cache in place.

    ``cache_len`` per row: each row writes at its own slot and masks
    scores past its own length.  With ``page_table`` the cache is a pool
    and attention walks the table with the fused decode kernel.
    ``update_cache=False`` is the cross-attention read (reference
    :378-380, :443-444): the cache holds the encoder's K/V, q takes no
    RoPE, nothing is written and positions ``< cache_len`` are
    attended; a page table is refused."""
    b = x.shape[0]
    if isinstance(cache_len, int):
        # filled on the device: a host scalar copied over is a transfer,
        # which a CUDA graph capture refuses
        cache_len = torch.full((b,), cache_len, dtype=torch.int64,
                               device=x.device)
    else:
        cache_len = torch.as_tensor(cache_len, device=x.device).reshape(-1)
        cache_len = cache_len.expand(b).to(torch.int64)
    paged = page_table is not None
    if paged and window is not None:
        raise NotImplementedError(
            "attention_decode: sliding-window attention over a paged KV "
            f"cache is not implemented (window={window} with page_table) — "
            "SWA uses contiguous ring caches; drop the window or use a "
            "contiguous cache")
    if paged and not update_cache:
        raise ValueError("paged KV caches do not support cross-attention "
                         "reads")
    ck, cv = cache["k"], cache["v"]
    page_size = ck.shape[1]
    max_len = page_table.shape[1] * page_size if paged else ck.shape[1]
    ring = (not paged) and window is not None and max_len <= window
    q = _split_heads(dense(p["wq"], x), num_heads)          # (B,1,H,dh)
    clen = cache_len[:, None]                               # (B, 1)
    if not update_cache:     # cross-attention: the encoder's K/V, no RoPE
        kpos = torch.arange(ck.shape[1], device=x.device)[None, :]
        return _decode_attend(p, x, q, ck, cv, kpos < clen, head_dim), cache
    knew = _split_heads(dense(p["wk"], x), kv_heads)
    vnew = _split_heads(dense(p["wv"], x), kv_heads)
    if use_rope:
        q, knew = _rotate(q, knew, clen, rope_theta, mrope_sections)
    if paged:
        pid = torch.gather(page_table.long(), 1,
                           (cache_len // page_size)[:, None])[:, 0]
        off = cache_len % page_size
        ck.index_put_((pid, off), knew[:, 0].to(ck.dtype))
        cv.index_put_((pid, off), vnew[:, 0].to(cv.dtype))
        o32 = ops.paged_attention_decode(
            q[:, 0], knew[:, 0], vnew[:, 0], ck, cv, page_table, cache_len)
        o = dense(p["wo"], o32.to(x.dtype).reshape(b, 1, num_heads * head_dim))
        return o, cache
    write_pos = cache_len % max_len if ring else cache_len
    _write_rows(write_pos, (ck, knew), (cv, vnew))

    kpos = torch.arange(ck.shape[1], device=x.device)[None, :]
    valid = kpos <= clen
    if window is not None and not ring:
        valid &= kpos > clen - window
    ck = logical_constraint(ck, "batch", "kv_seq", "kv", None)
    cv = logical_constraint(cv, "batch", "kv_seq", "kv", None)
    return _decode_attend(p, x, q, ck, cv, valid, head_dim), cache


def _write_rows(pos: torch.Tensor, *pairs) -> None:
    """``cache[r, pos[r]] = new[r, 0]`` for every row r of each
    ``(cache, new)`` pair, in place."""
    first = pairs[0][0]
    if not is_dtensor(first):
        rows = torch.arange(first.shape[0], device=first.device)
        for cache, new in pairs:
            cache[rows, pos] = new[:, 0].to(cache.dtype)
        return
    for cache, new in pairs:
        _write_shard_rows(cache, pos, new)


def _write_shard_rows(cache, pos, new) -> None:
    """``_write_rows`` on a DTensor cache: each rank writes into its own
    shard, its rows, and of those the positions inside its slice of the
    sequence."""
    row_off, nrows = shard_extent(cache, 0)
    seq_off, nseq = shard_extent(cache, 1)
    val = new.redistribute(cache.device_mesh, batch_placements(cache)).to_local()[:, 0]
    local = cache.to_local()
    rows = torch.arange(nrows, device=local.device)
    at = pos[row_off:row_off + nrows] - seq_off
    inside = (at >= 0) & (at < nseq)
    at = at.clamp(0, nseq - 1)
    local[rows, at] = torch.where(inside[:, None, None], val.to(local.dtype),
                                  local[rows, at])


def _decode_core(q, ck, cv, valid):
    """One query per row, q (B, 1, H, dh), over a contiguous cache (B, S,
    K, dh) at the positions where ``valid`` (B, S); fp32 softmax.
    Returns (B, 1, H, dh) fp32."""
    b, h, kv_heads, dh = q.shape[0], q.shape[2], ck.shape[2], q.shape[3]
    qg = q.reshape(b, 1, kv_heads, h // kv_heads, dh)
    scores = _gqa_scores(qg, ck) / math.sqrt(dh)            # (B,K,G,1,S)
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return _gqa_values(w, cv).reshape(b, 1, h, dh)          # (B,1,H,dh)


def _decode_attend(p, x, q, ck, cv, valid, head_dim):
    """``_decode_core`` (per rank's shards on DTensors), then the output
    projection."""
    b, h = q.shape[0], q.shape[2]
    q = logical_constraint(q, "batch", None, "heads", None)
    o = _per_head_shards(_decode_core, q, ck, cv, valid).to(x.dtype)
    return dense(p["wo"], o.reshape(b, 1, h * head_dim))
