"""Selective SSM (Mamba-1) block — torch port of ``src/repro/models/mamba.py``.

Recurrence (diagonal A):

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * B_t) x_t
    y_t = C_t . h_t + D * x_t

The sequence runs chunk by chunk at ``chunk`` positions, the fp32 state
``h`` (B, d_inner, d_state) carried across chunks.  Inside a chunk the
reference takes ``lax.associative_scan`` over the combine
``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)`` (:91-106); here the same
combine runs as a log-depth doubling (Hillis-Steele) scan, and the state
is applied after it as ``A_t h0 + B_t``, as there.  The two scans sum in
another order, so fp32 results agree within a few ulps (the parity tests
hold them to 1e-5), not bit for bit.  Where the reference switches its
chunk loop to ``lax.scan`` above ``CHUNK_UNROLL_LIMIT`` chunks, the port
keeps the Python loop: the arithmetic is the same.

Caches are ``{"conv": (B, d_conv - 1, d_inner), "ssm": (B, d_inner,
d_state) fp32}``.  ``mamba_prefill`` and ``mamba_decode`` write the new
state into the cache's tensors in place (a CUDA graph replays over
them) and also return the cache.  The projections are plain products
(``layers.dense``): the serving pruner leaves Mamba weights dense.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import logical_constraint
from .layers import dense, dense_init, truncated_normal

__all__ = ["mamba_init", "mamba_apply", "mamba_prefill", "mamba_decode",
           "init_mamba_cache"]


def mamba_init(d_model: int, *, generator, device, d_inner: Optional[int] = None,
               d_state: int = 16, d_conv: int = 4, dt_rank: Optional[int] = None,
               dtype=torch.float32) -> Dict:
    """Random Mamba params with the reference's leaves and shapes
    (truncated normals from ``generator``; ``a_log`` and ``d_skip`` fp32)."""
    d_inner = d_inner or 2 * d_model
    dt_rank = dt_rank or max(d_model // 16, 1)
    kw = dict(generator=generator, device=device, dtype=dtype)
    a = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=device)[None].repeat(d_inner, 1)
    return {
        "in_proj": dense_init(d_model, 2 * d_inner, **kw),
        "conv_kernel": truncated_normal((d_conv, d_inner), 0.3, dtype,
                                        generator=generator, device=device),
        "conv_bias_vec": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": dense_init(d_inner, dt_rank + 2 * d_state, **kw),
        "dt_proj": dense_init(dt_rank, d_inner, use_bias=True, **kw),
        "a_log": torch.log(a),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "out_proj": dense_init(d_inner, d_model, **kw),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence: x (B, S, di), kernel
    (K, di), fp32 taps.  Returns (y in x's dtype, the last K-1 inputs)."""
    k, s = kernel.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                  # (B, S+K-1, di)
    kf = kernel.to(torch.float32)
    y = xp[:, 0:s] * kf[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * kf[i]
    y = y + bias.to(torch.float32)
    return y.to(x.dtype), xp[:, xp.shape[1] - (k - 1):]


def _ssm_params(p: Dict, x: torch.Tensor):
    """x (B, L, di) -> dt (B, L, di), B (B, L, N), C (B, L, N), fp32."""
    dt_rank = p["dt_proj"]["kernel"].shape[0]
    d_state = (p["x_proj"]["kernel"].shape[1] - dt_rank) // 2
    proj = dense(p["x_proj"], x).to(torch.float32)
    dt_raw, bm, cm = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(torch.matmul(dt_raw, p["dt_proj"]["kernel"].to(torch.float32))
                    + p["dt_proj"]["bias"].to(torch.float32))
    return dt, bm, cm


def _ssm_chunk(h0, dt, bm, cm, x, a):
    """One chunk of the selective scan.  h0 (B, di, N); dt, x (B, L, di);
    bm, cm (B, L, N); a (di, N) negative.  Returns (y (B, L, di) fp32,
    h_last (B, di, N))."""
    acc = torch.exp(dt[..., None] * a)                      # (B, L, di, N)
    bcc = (dt * x)[..., None] * bm[:, :, None, :]           # (B, L, di, N)
    d = 1
    while d < acc.shape[1]:                # inclusive doubling scan, axis 1
        a_prev, b_prev = acc[:, :-d], bcc[:, :-d]
        a_cur, b_cur = acc[:, d:], bcc[:, d:]
        acc = torch.cat([acc[:, :d], a_prev * a_cur], dim=1)
        bcc = torch.cat([bcc[:, :d], b_prev * a_cur + b_cur], dim=1)
        d *= 2
    h = acc * h0[:, None] + bcc                              # (B, L, di, N)
    y = torch.einsum("bldn,bln->bld", h, cm)
    return y, h[:, -1]


def _mamba_forward(p: Dict, x: torch.Tensor, conv_state: Optional[torch.Tensor],
                   ssm_state: Optional[torch.Tensor], *, chunk: int = 256):
    """Full-sequence forward: (out, conv_state, ssm_state)."""
    b, s, _ = x.shape
    xi, z = torch.chunk(dense(p["in_proj"], x), 2, dim=-1)      # (B, S, di)
    xi = logical_constraint(xi, "batch", "seq", "mlp")
    xi, conv_state = _causal_conv(xi, p["conv_kernel"], p["conv_bias_vec"],
                                  state=conv_state)
    xi = F.silu(xi.to(torch.float32)).to(x.dtype)
    a = -torch.exp(p["a_log"].to(torch.float32))                # (di, N)
    di, n = a.shape
    chunk = min(chunk, s)
    h = (ssm_state if ssm_state is not None else
         torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    ys = []
    for c0 in range(0, s, chunk):
        xc = xi[:, c0:c0 + chunk]
        dt, bm, cm = _ssm_params(p, xc)
        y, h = _ssm_chunk(h, dt, bm, cm, xc.to(torch.float32), a)
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xi.to(torch.float32) * p["d_skip"].to(torch.float32)
    y = y * F.silu(z.to(torch.float32))
    return dense(p["out_proj"], y.to(x.dtype)), conv_state, h


def mamba_apply(p: Dict, x: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """Training forward, x (B, S, D) -> (B, S, D)."""
    return _mamba_forward(p, x, None, None, chunk=chunk)[0]


def _store(cache: Dict, conv: torch.Tensor, ssm: torch.Tensor) -> Dict:
    cache["conv"].copy_(conv)
    cache["ssm"].copy_(ssm)
    return cache


def mamba_prefill(p: Dict, x: torch.Tensor, cache: Dict, *, chunk: int = 256
                  ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward from the cache's state; the last K-1 conv
    inputs and the final SSM state go into ``cache``."""
    out, conv, h = _mamba_forward(p, x, cache["conv"].to(x.dtype), cache["ssm"],
                                  chunk=chunk)
    return out, _store(cache, conv, h)


def init_mamba_cache(batch: int, d_inner: int, d_state: int, d_conv: int,
                     dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p: Dict, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token step, x (B, 1, D) -> (y (B, 1, D), cache advanced in place)."""
    xi, z = torch.chunk(dense(p["in_proj"], x), 2, dim=-1)      # (B, 1, di)
    xi, conv = _causal_conv(xi, p["conv_kernel"], p["conv_bias_vec"],
                            state=cache["conv"].to(xi.dtype))
    xi = F.silu(xi.to(torch.float32)).to(x.dtype)
    dt, bm, cm = _ssm_params(p, xi)                             # (B, 1, .)
    a = -torch.exp(p["a_log"].to(torch.float32))
    dta = torch.exp(dt[:, 0, :, None] * a)                      # (B, di, N)
    dbx = (dt[:, 0] * xi[:, 0].to(torch.float32))[..., None] * bm[:, 0, None, :]
    h = dta * cache["ssm"] + dbx
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0])[:, None]        # (B, 1, di)
    y = y + xi.to(torch.float32) * p["d_skip"].to(torch.float32)
    y = y * F.silu(z.to(torch.float32))
    return dense(p["out_proj"], y.to(x.dtype)), _store(cache, conv, h)
