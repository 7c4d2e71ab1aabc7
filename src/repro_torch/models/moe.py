"""Mixture-of-Experts: top-k token-choice routing with capacity and a
sort-based dispatch — torch port of ``src/repro/models/moe.py:45-188``
(without the sharding constraints).

Semantics are the reference's, step for step:

* the router weight is fp32 whatever the param dtype; logits, softmax
  and top-k are fp32, and the gates are renormalised, then cast to the
  activation dtype *before* dispatch;
* tokens route within ``g = gcd(groups or B, B*S)`` groups of ``n``;
  each expert takes ``cap = max(ceil(n * k * cf / E), k)`` slots;
* position within an expert comes from a stable sort by expert id and a
  ``searchsorted`` of each expert's start; slots at ``pos >= cap`` drop;
* the expert FFN is ``layers.expert_matmul`` on the (g, E, C, d) buffer
  (one planes-kernel launch per matmul on ``BSRPlanes`` leaves), with
  ``act(gate) * up`` fused into the gate matmul's epilogue;
* the dispatch's row counts ride along: ``min(tokens routed to e, cap)``
  rows of segment (g, e) hold a token and the rest of the buffer is zero
  rows, so each expert matmul gets the (g, E) int32 counts
  (``expert_row_counts``, computed on the device from the ``starts`` the
  sort already has, no host sync) and the planes kernel loads no weight
  tile for rows past them, nor for an expert no token was routed to.
  Those rows are zero in the buffer, and the down matmul's input there is
  ``act(0) * 0 = 0``, so the output is bit-identical with and without the
  counts;
* the Switch aux loss is ``E * sum_e(mean prob_e * top-1 fraction_e)``.

What differs, for the card:

* top-k and the dispatch sort are stable sorts, so ties go to the lowest
  expert id or slot as in ``jax.lax.top_k`` / ``argsort(stable=True)``;
* every shape is static and nothing reads back to the host: dropped
  slots scatter into a scratch row ``C`` of an (E, C+1) buffer that is
  then sliced off;
* the combine adds each token's k slot outputs left to right in a fixed
  loop, in the order the reference's scatter-add visits them (by expert
  id), instead of ``index_add_``, whose CUDA atomics add in a
  run-dependent order;
* router logits are an exact fp32 product reduced over the contiguous
  last dim, whose reduction order does not change with the number of
  tokens, so a token's routing is the same alone and in a batch (a
  cuBLAS matmul may pick another algorithm at M = 1 than at M = 4).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.epilogue import Epilogue
from .layers import expert_matmul, truncated_normal

__all__ = ["moe_init", "moe_apply", "moe_decode", "router_logits",
           "expert_row_counts"]


def moe_init(d_model: int, d_ff: int, num_experts: int, *, generator, device,
             gated: bool = True, dtype=torch.float32) -> Dict:
    std_in = 1.0 / math.sqrt(d_model)
    std_out = 1.0 / math.sqrt(d_ff)
    kw = dict(generator=generator, device=device)
    p = {
        "router": {"kernel": truncated_normal((d_model, num_experts), std_in,
                                              torch.float32, **kw)},
        "experts_up": truncated_normal((num_experts, d_model, d_ff), std_in,
                                       dtype, **kw),
        "experts_down": truncated_normal((num_experts, d_ff, d_model), std_out,
                                         dtype, **kw),
    }
    if gated:
        p["experts_gate"] = truncated_normal((num_experts, d_model, d_ff),
                                             std_in, dtype, **kw)
    return p


def router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits (..., E) of x (..., d) against w (d, E): exact fp32
    products summed over the contiguous last dim, one token at a time."""
    w_t = w.to(torch.float32).T.contiguous()                    # (E, d)
    return (x.to(torch.float32)[..., None, :] * w_t).sum(dim=-1)


def expert_row_counts(starts: torch.Tensor, n_slots: int,
                      cap: int) -> torch.Tensor:
    """(g, E) int32 kept rows of every (group, expert) segment of the
    capacity buffer, ``min(tokens routed to e, cap)``, from the dispatch's
    (g, E) ``starts`` (first sorted slot of each expert) and the ``n_slots
    = n * k`` slots of a group."""
    ends = torch.cat([starts[:, 1:],
                      torch.full_like(starts[:, :1], n_slots)], dim=1)
    return torch.clamp(ends - starts, max=cap).to(torch.int32)


def moe_apply(
    p: Dict,
    x: torch.Tensor,               # (B, S, D)
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    groups: Optional[int] = None,
    activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x.dtype, aux loss scalar fp32)."""
    b, s, d = x.shape
    t = b * s
    g = math.gcd(groups or b, t)
    n = t // g                                     # tokens per group
    e_n, k = num_experts, top_k
    cap = max(int(math.ceil(n * k * capacity_factor / e_n)), k)
    dev = x.device
    xt = x.reshape(g, n, d)

    # --- routing (fp32) --------------------------------------------------
    probs = torch.softmax(router_logits(xt, p["router"]["kernel"]), dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[..., :k], expert[..., :k]                # (g, n, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = torch.nn.functional.one_hot(expert[..., 0], e_n).to(
        torch.float32).mean(dim=(0, 1))
    aux = e_n * torch.sum(me * ce)

    # --- sort-based dispatch ----------------------------------------------
    eflat = expert.reshape(g, n * k)
    gflat = gate.reshape(g, n * k).to(x.dtype)
    order = torch.argsort(eflat, dim=-1, stable=True)            # (g, nk)
    se = torch.gather(eflat, -1, order)
    sg = torch.gather(gflat, -1, order)
    stok = order // k                              # source token per slot
    starts = torch.searchsorted(
        se, torch.arange(e_n, device=dev).expand(g, e_n).contiguous())
    pos = torch.arange(n * k, device=dev)[None] - torch.gather(starts, -1, se)
    keep = pos < cap                               # capacity drop
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    gathered = torch.gather(xt, 1, stok[..., None].expand(g, n * k, d))
    # kept slots land at (e, pos), each at most once; dropped ones in the
    # scratch row `cap`, sliced off below
    row = torch.where(keep, pos, torch.full_like(pos, cap))
    buf = torch.zeros((g, e_n * (cap + 1), d), dtype=x.dtype, device=dev)
    buf.scatter_(1, (se * (cap + 1) + row)[..., None].expand(g, n * k, d),
                 gathered)
    buffer = buf.reshape(g, e_n, cap + 1, d)[:, :, :cap]        # (g, E, C, d)

    # --- expert compute (BSRPlanes: one planes-kernel launch each) -------
    counts = expert_row_counts(starts, n * k, cap)
    if "experts_gate" in p:
        up = expert_matmul(buffer, p["experts_up"], row_counts=counts)
        h = expert_matmul(buffer, p["experts_gate"],
                          epilogue=Epilogue(activation=activation,
                                            multiplier=up),
                          row_counts=counts)
    else:
        h = expert_matmul(buffer, p["experts_up"],
                          epilogue=Epilogue(activation=activation),
                          row_counts=counts)
    h = h.to(x.dtype)
    out_e = expert_matmul(h, p["experts_down"],
                          row_counts=counts).to(x.dtype)         # (g, E, C, d)

    # --- combine ------------------------------------------------------------
    back = out_e.reshape(g, e_n * cap, d)
    per_slot = torch.gather(back, 1, (se * cap + pos_c)[..., None].expand(
        g, n * k, d))
    per_slot = per_slot * torch.where(keep, sg, torch.zeros_like(sg))[..., None]
    # each token's k slots, by sorted position (= expert id order)
    inv = torch.argsort(order, dim=-1)
    tok_slots = torch.sort(inv.reshape(g, n, k), dim=-1).values.reshape(g, n * k)
    vals = torch.gather(per_slot, 1, tok_slots[..., None].expand(g, n * k, d))
    vals = vals.reshape(g, n, k, d)
    out = torch.zeros((g, n, d), dtype=x.dtype, device=dev)
    for j in range(k):
        out = out + vals[:, :, j]
    return out.reshape(b, s, d), aux


def moe_decode(p: Dict, x: torch.Tensor, *, num_experts: int, top_k: int,
               capacity_factor: float = 2.0,
               activation: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode path: the same dispatch over one group of the B tokens, at
    a generous capacity factor (token counts are tiny at decode: 4 tokens
    x top-8 fill 32 of granite's 32 x 8 capacity rows)."""
    return moe_apply(p, x, num_experts=num_experts, top_k=top_k,
                     capacity_factor=capacity_factor, groups=1,
                     activation=activation)
