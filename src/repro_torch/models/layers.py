"""Primitive layers: dense, rmsnorm, layernorm, embeddings, rotary (RoPE and
Qwen2-VL's M-RoPE), sinusoidal positions — torch port.

Counterpart of ``src/repro/models/layers.py``.  Params are nested dicts
of tensors with the reference's leaf names ("kernel", "bias", "scale",
"embedding"); matmul kernels are (in, out).

Matmuls accumulate in fp32 like the reference's
``preferred_element_type=float32``: a bf16 ``torch.matmul`` would round
its output to bf16, so dense products widen their operands to fp32 first
(products of bf16 values are exact in fp32).  ``matmul`` is the one
sparse-execution dispatch point: a packed ``BSRWeight`` goes to
``kernels.ops.bsr_matmul`` (the Hopper kernel on the card);
``expert_matmul`` is its counterpart for (E, d, f) expert stacks, where a
``BSRPlanes`` goes to ``kernels.ops.bsr_planes_matmul`` in one call.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.packing import BSRPlanes, BSRWeight
from repro_torch.distributed.sharding import (gather_fsdp, is_dtensor,
                                              logical_constraint, reduce_partial,
                                              grad_as_input, shard_extent,
                                              shard_map)
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import apply_epilogue, make_epilogue

__all__ = [
    "matmul", "expert_matmul", "dense", "dense_init", "rmsnorm", "rmsnorm_init",
    "layernorm", "layernorm_init",
    "embed_init", "embed_lookup", "unembed_logits",
    "rope_frequencies", "apply_rope", "apply_mrope", "sinusoidal_positions",
    "truncated_normal",
]


def truncated_normal(shape, stddev: float, dtype, *, generator: torch.Generator,
                     device) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``stddev``: uniforms from
    ``generator`` on ``device`` through the inverse normal CDF, in fp32,
    cast to ``dtype``."""
    lo, hi = 0.022750131948179195, 0.9772498680518208   # Phi(-2), Phi(2)
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return (x.clamp_(-2.0, 2.0) * stddev).to(dtype)


def dense_init(in_dim: int, out_dim: int, *, generator, device,
               use_bias: bool = False, dtype=torch.float32,
               stddev: Optional[float] = None) -> Dict[str, torch.Tensor]:
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(in_dim)
    p = {"kernel": truncated_normal((in_dim, out_dim), stddev, dtype,
                                    generator=generator, device=device)}
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def matmul(x: torch.Tensor, w, *, accum=torch.float32, epilogue=None) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N) in ``accum``, with the fused
    epilogue.  A packed leaf runs the BSR kernel; a dense leaf is an fp32
    ``torch.matmul`` followed by the same epilogue op order."""
    if isinstance(w, BSRWeight):
        return ops.bsr_matmul(x, w, epilogue=epilogue).to(accum)
    if is_dtensor(x) or is_dtensor(w):
        return apply_epilogue(_sharded_matmul(x, w, accum), epilogue)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(accum)
    return apply_epilogue(y, epilogue)


def _sharded_matmul(x, w, accum):
    """The product on DTensors: the FSDP weight gathered, the input's
    gradient placed as the input, a partial-sum output reduced."""
    x, w = grad_as_input(x), gather_fsdp(w)
    return reduce_partial(torch.matmul(x.to(torch.float32),
                                       w.to(torch.float32)).to(accum))


def expert_matmul(h: torch.Tensor, w, *, accum=torch.float32,
                  epilogue=None, row_counts=None) -> torch.Tensor:
    """Batched expert matmul (g, E, C, d) @ (E, d, f) -> (g, E, C, f) in
    ``accum`` (reference ``layers.py:90``).  A ``BSRPlanes`` leaf makes ONE
    ``ops.bsr_planes_matmul`` call over the whole stack: E moves to the
    front and the operands are made contiguous (the kernel's output is
    ``h.dtype``, and its multiplier/residual must be too — a multiplier
    that is itself such an output widened to fp32 narrows back exactly).
    A dense leaf is an fp32 einsum followed by the same epilogue.

    ``row_counts`` (g, E) int32: rows ``c >= row_counts[g, e]`` of segment
    (g, e) are taken as zero rows of h (the planes kernel skips them and
    writes ``epilogue(0)`` there); None: every row is live."""
    if isinstance(w, BSRPlanes):
        he = h.transpose(0, 1).contiguous()                   # (E, g, C, d)
        epi = None if epilogue is None else epilogue.map_operands(
            lambda a: a.transpose(0, 1).to(h.dtype).contiguous())
        counts = None if row_counts is None else row_counts.T.contiguous()
        y = ops.bsr_planes_matmul(he, w, epilogue=epi, row_counts=counts)
        return y.transpose(0, 1).to(accum)                    # (g, E, C, f)
    if row_counts is not None:
        live = torch.arange(h.shape[2], device=h.device) < row_counts[..., None]
        h = torch.where(live[..., None], h,
                        torch.zeros((), dtype=h.dtype, device=h.device))
    y = torch.einsum("gecd,edf->gecf", h.to(torch.float32),
                     w.to(torch.float32)).to(accum)
    return apply_epilogue(y, epilogue)


def dense(p: Dict, x: torch.Tensor, *, accum=torch.float32,
          activation: Optional[str] = None,
          multiplier: Optional[torch.Tensor] = None,
          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Matmul with the fused tail ``act(y + bias) * multiplier +
    residual``; returns x's dtype."""
    epi = make_epilogue(bias=p.get("bias"), activation=activation,
                        multiplier=multiplier, residual=residual)
    return matmul(x, p["kernel"], accum=accum, epilogue=epi).to(x.dtype)


def rmsnorm_init(dim: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm_init(dim: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias_vec": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics (biased variance, as ``jnp.var``), the result cast
    back to x's dtype (reference :149-159)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias_vec"].to(torch.float32)
    return y.to(x.dtype)


def embed_init(vocab: int, dim: int, *, generator, device,
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {"embedding": truncated_normal((vocab, dim), 1.0, dtype,
                                          generator=generator, device=device)}


def embed_lookup(p, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """(B, S) int -> (B, S, D), a row gather of the table (of a DTensor
    table, ``_sharded_lookup``)."""
    table = p["embedding"]
    if is_dtensor(table):
        out = _sharded_lookup(table, tokens)
    else:
        out = table[tokens.long()]
    out = logical_constraint(out, "batch", "seq", "embed")
    return out.to(dtype or table.dtype)


def _sharded_lookup(table, tokens):
    """The lookup on each rank's shards, as GSPMD partitions the
    reference's ``take`` (:173): the table's d_model gathered, each rank
    gathers the tokens of its vocab rows and zeros for the others, and the
    result is a partial sum over the vocab's axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    vocab = [pl == Shard(0) for pl in table.placements]
    tok_pl = tokens.placements if is_dtensor(tokens) else [Replicate()] * len(vocab)
    tok = [Replicate() if v else pl for v, pl in zip(vocab, tok_pl)]
    rows = [Shard(0) if v else Replicate() for v in vocab]
    out = [Partial() if v else pl for v, pl in zip(vocab, tok)]
    grad = [Shard(0) if v else (Partial() if pl.is_shard() else Replicate())
            for v, pl in zip(vocab, tok)]
    v_off, v_len = shard_extent(table.redistribute(placements=rows), 0)

    def lookup(t, ids):
        at = ids.long() - v_off
        inside = (at >= 0) & (at < v_len)
        got = t[at.clamp(0, v_len - 1)]
        return torch.where(inside[..., None], got, torch.zeros_like(got))

    return shard_map(lookup, in_placements=(rows, tok), out_placements=out,
                     in_grad_placements=(grad, tok))(table, tokens)


def unembed_logits(p, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) fp32 logits from fp32 accumulation,
    vocab-sharded under the rules."""
    table = p["embedding"]
    if not (is_dtensor(x) or is_dtensor(table)):
        return torch.matmul(x.to(torch.float32), table.to(torch.float32).T)
    x, table = grad_as_input(x), gather_fsdp(table)
    logits = torch.matmul(x.to(torch.float32), table.to(torch.float32).T)
    return logical_constraint(logits, "batch", "seq", "vocab")


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rope_rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Half-split rotation: x (..., dh); sin/cos broadcast to (..., dh/2)."""
    half = x.shape[-1] // 2
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, dh), positions (B, S) -> rotated x."""
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    ang = positions.to(torch.float32)[..., None] * inv      # (B, S, dh/2)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    return _rope_rotate(x, sin, cos)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections, *,
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE (reference :213): x (B, S, H, dh),
    positions (B, S, 3) = (temporal, height, width) ids.  The dh/2
    frequency slots split into ``sections`` (e.g. (16, 24, 24)); the
    slots of section i rotate by position component i."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    comp = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                      for i, n in enumerate(sections)])
    ang = positions.to(torch.float32)[..., comp] * inv      # (B, S, dh/2)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    return _rope_rotate(x, sin, cos)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings (reference :238), (length,
    dim) fp32: the sines of every frequency, then the cosines (not
    interleaved).  Computed in float64 as numpy does there, then
    rounded to fp32."""
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float64)[None, :]
    angle = pos / (10000.0 ** (2 * idx / dim))
    out = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return out.to(device=device, dtype=torch.float32)
