"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory) — torch
port of ``src/repro/models/xlstm.py`` (Beck et al. 2024, arXiv:2405.04517).

* mLSTM runs in chunked parallel form: inside a chunk a stabilized
  quadratic form with log-sigmoid forget gates, across chunks the
  recurrent state (C, n, m) with its max-stabilizer ``m``.  The chunk
  loop is Python where the reference switches to ``lax.scan`` above
  ``CHUNK_UNROLL_LIMIT`` chunks; the chunk body is the same.
* sLSTM is sequential: the input projection is one product over the
  whole sequence, then one step per position with the block-diagonal
  recurrent weight ``r_rec`` (heads, dh, 4 dh).

Two details of the reference that a port gets wrong easily: ``jax.nn.
gelu`` is the tanh approximation (:277, :308), and the mLSTM
denominator is clamped as ``max(|denom|, exp(-m))`` (:95, :217).

Caches: mLSTM ``{"C": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H)}``,
sLSTM ``{"c", "n", "h", "m"}`` each (B, d), all fp32.  The prefill and
decode functions write the new state into the cache's tensors in place
and also return the cache.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (batch_placements, grad_as_input,
                                              is_dtensor, logical_constraint,
                                              shard_map, whole_groups)
from .layers import dense, dense_init, truncated_normal

__all__ = [
    "mlstm_init", "mlstm_apply", "mlstm_prefill", "mlstm_decode",
    "init_mlstm_cache",
    "slstm_init", "slstm_apply", "slstm_prefill", "slstm_decode",
    "init_slstm_cache",
]

_NEG = -1e30                     # the stabilizer's "no history yet"


def _store(cache: Dict, new: Dict) -> Dict:
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init(d_model: int, num_heads: int, *, generator, device,
               proj_factor: float = 2.0, dtype=torch.float32) -> Dict:
    d_in = int(proj_factor * d_model)
    d_in -= d_in % num_heads
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "up_proj": dense_init(d_model, d_in, **kw),
        "gate_proj": dense_init(d_model, d_in, **kw),
        "wq": dense_init(d_in, d_in, **kw),
        "wk": dense_init(d_in, d_in, **kw),
        "wv": dense_init(d_in, d_in, **kw),
        "wif": dense_init(d_in, 2 * num_heads, use_bias=True, **kw),
        "down_proj": dense_init(d_in, d_model, **kw),
    }


def _mlstm_chunk(carry, q, k, v, ig, fg):
    """One chunk.  carry (C (B,H,dk,dv), n (B,H,dk), m (B,H)); q, k, v
    (B,H,L,dh) fp32; ig, fg (B,H,L) gate pre-activations.  Returns
    (new carry, h (B,H,L,dh))."""
    c_p, n_p, m_p = carry
    l, dh = q.shape[2], q.shape[3]
    logf = F.logsigmoid(fg)
    fcum = torch.cumsum(logf, dim=-1)                    # decay chunk start -> t
    f_total = fcum[..., -1]

    d_intra = fcum[..., :, None] - fcum[..., None, :] + ig[..., None, :]
    tri = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    d_intra = torch.where(tri, d_intra, float("-inf"))
    m_intra = torch.amax(d_intra, dim=-1)
    m_inter = m_p[..., None] + fcum
    m_t = torch.clamp_min(torch.maximum(m_inter, m_intra), _NEG)

    scale = 1.0 / math.sqrt(dh)
    s_intra = torch.einsum("bhld,bhtd->bhlt", q, k) * scale
    w_intra = s_intra * torch.exp(d_intra - m_t[..., None])
    inter = torch.exp(m_inter - m_t)
    numer = (torch.einsum("bhlt,bhtd->bhld", w_intra, v)
             + inter[..., None] * torch.einsum("bhld,bhdv->bhlv", q * scale, c_p))
    denom = (torch.sum(w_intra, dim=-1)
             + inter * torch.einsum("bhld,bhd->bhl", q * scale, n_p))
    hidden = numer / torch.maximum(torch.abs(denom), torch.exp(-m_t))[..., None]

    decay_to_end = f_total[..., None] - fcum + ig
    m_new = torch.maximum(m_p + f_total, torch.amax(decay_to_end, dim=-1))
    kd = k * torch.exp(decay_to_end - m_new[..., None])[..., None]
    carry_f = torch.exp(m_p + f_total - m_new)
    c_new = carry_f[..., None, None] * c_p + torch.einsum("bhtd,bhtv->bhdv", kd, v)
    n_new = carry_f[..., None] * n_p + torch.sum(kd, dim=2)
    return (c_new, n_new, m_new), hidden


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    x = whole_groups(x, 2, h)
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h).transpose(1, 2)         # (B, H, S, dh)


def _mlstm_qkv(p: Dict, x: torch.Tensor, num_heads: int):
    """Projections of x (B, S, D): xin and gate in x's dtype, q, k, v
    (B,H,S,dh) and the gate pre-activations ig, fg (B,H,S) in fp32."""
    xin = dense(p["up_proj"], x)
    gate = dense(p["gate_proj"], x)
    q, k, v = (logical_constraint(
        _heads(dense(p[w], xin), num_heads).to(torch.float32),
        "batch", "heads", "seq", None) for w in ("wq", "wk", "wv"))
    ig, fg = torch.chunk(dense(p["wif"], xin).to(torch.float32), 2, dim=-1)
    return xin, gate, q, k, v, ig.transpose(1, 2), fg.transpose(1, 2)


def _mlstm_out(p: Dict, x: torch.Tensor, hid: torch.Tensor, gate: torch.Tensor):
    """hid (B, S, d_in) fp32 -> gated down projection (B, S, D)."""
    out = hid.to(x.dtype) * F.silu(gate.to(torch.float32)).to(x.dtype)
    return dense(p["down_proj"], out)


def _mlstm_forward(p: Dict, x: torch.Tensor, carry, *, num_heads: int,
                   chunk: int = 256):
    b, s, _ = x.shape
    xin, gate, q, k, v, ig, fg = _mlstm_qkv(p, x, num_heads)
    d_in = xin.shape[-1]
    dh = d_in // num_heads
    if carry is None:
        z = dict(device=x.device, dtype=torch.float32)
        carry = (torch.zeros((b, num_heads, dh, dh), **z),
                 torch.zeros((b, num_heads, dh), **z),
                 torch.full((b, num_heads), _NEG, **z))
    chunk = min(chunk, s)

    def scan(c, n, m, q, k, v, ig, fg):
        carry = (c, n, m)
        hs = []
        for c0 in range(0, s, chunk):
            sl = slice(c0, c0 + chunk)
            carry, hid = _mlstm_chunk(carry, q[:, :, sl], k[:, :, sl],
                                      v[:, :, sl], ig[:, :, sl], fg[:, :, sl])
            hs.append(hid)
        return (*carry, torch.cat(hs, dim=2) if len(hs) > 1 else hs[0])

    # independent per (batch row, head): each rank scans its shards
    pl = tuple(q.placements) if is_dtensor(q) else None
    *carry, hid = shard_map(scan, in_placements=(pl,) * 8,
                            out_placements=(pl,) * 4)(*carry, q, k, v, ig, fg)
    # from (B, H, S, dh); its gradient comes back placed as it is, so the
    # merge's backward can split the heads again
    hid = grad_as_input(hid.transpose(1, 2).reshape(b, s, d_in))
    return _mlstm_out(p, x, hid, gate), tuple(carry)


def mlstm_apply(p: Dict, x: torch.Tensor, *, num_heads: int,
                chunk: int = 256) -> torch.Tensor:
    return _mlstm_forward(p, x, None, num_heads=num_heads, chunk=chunk)[0]


def mlstm_prefill(p: Dict, x: torch.Tensor, cache: Dict, *, num_heads: int,
                  chunk: int = 256) -> Tuple[torch.Tensor, Dict]:
    """Chunked-parallel forward from the cache's (C, n, m); the final
    state goes into ``cache``."""
    out, (c, n, m) = _mlstm_forward(p, x, (cache["C"], cache["n"], cache["m"]),
                                    num_heads=num_heads, chunk=chunk)
    return out, _store(cache, {"C": c, "n": n, "m": m})


def init_mlstm_cache(batch: int, num_heads: int, head_dim: int,
                     device=None) -> Dict[str, torch.Tensor]:
    z = dict(device=device, dtype=torch.float32)
    return {"C": torch.zeros((batch, num_heads, head_dim, head_dim), **z),
            "n": torch.zeros((batch, num_heads, head_dim), **z),
            "m": torch.full((batch, num_heads), _NEG, **z)}


def mlstm_decode(p: Dict, x: torch.Tensor, cache: Dict, *, num_heads: int
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step, x (B, 1, D)."""
    b = x.shape[0]
    xin, gate, q, k, v, ig, fg = _mlstm_qkv(p, x, num_heads)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]                # (B, H, dh)
    ig, fg = ig[..., 0], fg[..., 0]                             # (B, H)
    # independent per (batch row, head): each rank steps its shards
    pl = tuple(q.placements) if is_dtensor(q) else None
    c, n, m_new, h = shard_map(_mlstm_step, in_placements=(pl,) * 8,
                               out_placements=(pl,) * 4)(
        q, k, v, ig, fg, cache["C"], cache["n"], cache["m"])
    out = _mlstm_out(p, x, h.reshape(b, 1, -1), gate)
    return out, _store(cache, {"C": c, "n": n, "m": m_new})


def _mlstm_step(q, k, v, ig, fg, c_p, n_p, m_p):
    """One decode step of the mLSTM recurrence: q, k, v (B, H, dh), gate
    pre-activations (B, H), the cache's C, n, m.  Returns (C, n, m, h)."""
    dh = q.shape[-1]
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(m_p + logf, ig)
    cf = torch.exp(m_p + logf - m_new)
    ci = torch.exp(ig - m_new)
    scale = 1.0 / math.sqrt(dh)
    c = (cf[..., None, None] * c_p
         + ci[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = cf[..., None] * n_p + ci[..., None] * k
    numer = torch.einsum("bhd,bhdv->bhv", q * scale, c)
    denom = torch.einsum("bhd,bhd->bh", q * scale, n)
    h = numer / torch.maximum(torch.abs(denom), torch.exp(-m_new))[..., None]
    return c, n, m_new, h


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_init(d_model: int, num_heads: int, *, generator, device,
               ff_factor: float = 4 / 3, dtype=torch.float32) -> Dict:
    dh = d_model // num_heads
    d_ff = int(ff_factor * d_model)
    d_ff += (-d_ff) % 128
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w_in": dense_init(d_model, 4 * d_model, use_bias=True, **kw),
        "r_rec": truncated_normal((num_heads, dh, 4 * dh), 1.0 / math.sqrt(dh),
                                  dtype, generator=generator, device=device),
        "up": dense_init(d_model, d_ff, **kw),
        "down": dense_init(d_ff, d_model, **kw),
    }


def _slstm_step(state, wx_t, r_rec, num_heads):
    """state (c, n, h, m) each (B, d) fp32; wx_t (B, 4d) fp32."""
    c, n, h, m = state
    b, d = h.shape
    dh = d // num_heads
    rh = torch.einsum("bhd,hde->bhe", h.reshape(b, num_heads, dh),
                      r_rec.to(torch.float32))                   # (B, H, 4dh)
    rh = rh.reshape(b, num_heads, 4, dh).transpose(1, 2).reshape(b, 4 * d)
    zt, it, ft, ot = torch.chunk(wx_t + rh, 4, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    cf = torch.exp(logf + m - m_new)
    ci = torch.exp(it - m_new)
    c_new = cf * c + ci * z
    n_new = cf * n + ci
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_mlp(p: Dict, x: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """The block's post-MLP over hs (B, S, d) fp32, tanh-approximate GELU."""
    h2 = dense(p["up"], hs.to(x.dtype))
    h2 = F.gelu(h2.to(torch.float32), approximate="tanh").to(x.dtype)
    return dense(p["down"], h2)


def _slstm_scan(wx, r_rec, c, n, h, m, *, num_heads: int):
    """The time loop over wx (B, S, 4d): (c, n, h, m, hs (B, S, d))."""
    state, hs = (c, n, h, m), []
    for t in range(wx.shape[1]):
        state, hh = _slstm_step(state, wx[:, t], r_rec, num_heads)
        hs.append(hh)
    return (*state, torch.stack(hs, dim=1))


def _per_batch_shard(fn, n_out: int, wx, r_rec, *state):
    """``fn(wx, r_rec, *state)`` (``n_out`` outputs, batch first), the
    sLSTM recurrence (its heads mix in the recurrent matmul's layout), on
    each rank's batch shard of DTensor inputs, replicated over the other
    axes; ``r_rec``'s gradient is a partial sum over the batch's axes.
    Plain tensors: ``fn`` itself."""
    from torch.distributed.tensor import Partial, Replicate

    pl = batch_placements(wx)
    if pl is None:
        return fn(wx, r_rec, *state)
    rep = tuple(Replicate() for _ in pl)
    over_batch = tuple(Partial() if p.is_shard() else p for p in pl)
    return shard_map(fn, in_placements=(pl, rep) + (pl,) * len(state),
                     out_placements=(pl,) * n_out,
                     in_grad_placements=(pl, over_batch) + (pl,) * len(state))(
        wx, r_rec, *state)


def _slstm_forward(p: Dict, x: torch.Tensor, state, *, num_heads: int):
    wx = dense(p["w_in"], x).to(torch.float32)                  # (B, S, 4d)
    *state, hs = _per_batch_shard(
        functools.partial(_slstm_scan, num_heads=num_heads), 5, wx, p["r_rec"], *state)
    return _slstm_mlp(p, x, hs), tuple(state)


def init_slstm_cache(batch: int, d_model: int, device=None) -> Dict[str, torch.Tensor]:
    z = dict(device=device, dtype=torch.float32)
    return {"c": torch.zeros((batch, d_model), **z),
            "n": torch.full((batch, d_model), 1e-6, **z),
            "h": torch.zeros((batch, d_model), **z),
            "m": torch.full((batch, d_model), _NEG, **z)}


_SLSTM_KEYS = ("c", "n", "h", "m")


def slstm_apply(p: Dict, x: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    st = init_slstm_cache(x.shape[0], x.shape[2], device=x.device)
    return _slstm_forward(p, x, tuple(st[k] for k in _SLSTM_KEYS),
                          num_heads=num_heads)[0]


def slstm_prefill(p: Dict, x: torch.Tensor, cache: Dict, *, num_heads: int
                  ) -> Tuple[torch.Tensor, Dict]:
    """Sequential scan from the cache's state; the final state goes into
    ``cache``."""
    out, state = _slstm_forward(p, x, tuple(cache[k] for k in _SLSTM_KEYS),
                                num_heads=num_heads)
    return out, _store(cache, dict(zip(_SLSTM_KEYS, state)))


def slstm_decode(p: Dict, x: torch.Tensor, cache: Dict, *, num_heads: int
                 ) -> Tuple[torch.Tensor, Dict]:
    wx = dense(p["w_in"], x).to(torch.float32)[:, 0]            # (B, 4d)
    state = _per_batch_shard(functools.partial(_slstm_one, num_heads=num_heads), 4,
                             wx, p["r_rec"], *(cache[k] for k in _SLSTM_KEYS))
    return _slstm_mlp(p, x, state[2][:, None]), _store(cache, dict(zip(_SLSTM_KEYS, state)))


def _slstm_one(wx, r_rec, c, n, h, m, *, num_heads: int):
    """One step of the recurrence: the new (c, n, h, m)."""
    return _slstm_step((c, n, h, m), wx, r_rec, num_heads)[0]
