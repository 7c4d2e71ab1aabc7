"""Mixture-of-Experts: top-k token-choice routing with capacity and a
sort-based dispatch — torch port of ``src/repro/models/moe.py:45-188``.

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

On DTensors (the sharded program) the reference's constraints apply
(:87-174) and the three stages run on each rank's shards
(``_moe_sharded``), as its ``vmap`` over groups is local per data shard:
the routing and dispatch per group shard, the expert FFN with the
capacity dim on "expert_cap", the combine as a partial sum over the
capacity shards.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (batch_placements, current_mesh,
                                              gather_fsdp, is_dtensor,
                                              logical_constraint, shard_extent,
                                              shard_map)
from repro_torch.kernels.epilogue import Epilogue
from .layers import expert_matmul, truncated_normal
from .remat import saved_product

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
    products summed over the contiguous last dim, one token at a time.
    Under ``remat="dots"`` the logits are kept, as the reference keeps
    its router product's."""
    w_t = w.to(torch.float32).T.contiguous()                    # (E, d)
    prod = x.to(torch.float32)[..., None, :] * w_t
    with saved_product():
        return prod.sum(dim=-1)


def expert_row_counts(starts: torch.Tensor, n_slots: int,
                      cap: int) -> torch.Tensor:
    """(g, E) int32 kept rows of every (group, expert) segment of the
    capacity buffer, ``min(tokens routed to e, cap)``, from the dispatch's
    (g, E) ``starts`` (first sorted slot of each expert) and the ``n_slots
    = n * k`` slots of a group."""
    ends = torch.cat([starts[:, 1:],
                      torch.full_like(starts[:, :1], n_slots)], dim=1)
    return torch.clamp(ends - starts, max=cap).to(torch.int32)


def _cap_sharded(num_experts: int) -> bool:
    """The capacity dim goes on "expert_cap" when E divides the installed
    mesh's "model" axis, where the expert weights are FSDP'd; under the
    intra-expert TP fallback (E smaller than the axis) it stays whole, as
    in the reference (``_cap_axis_ok``, moe.py:30)."""
    mesh = current_mesh()
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return False
    return num_experts % mesh.size(mesh.mesh_dim_names.index("model")) == 0


def _route(xt, router_w, *, e_n: int, k: int, cap: int):
    """Routing and the sort dispatch of (g, n, d) tokens, each group on its
    own: returns the (g, E, C, d) buffer, its (g, E) row counts, the
    sorted slots' experts, gates, positions, keep flags and sort order,
    and the means over the groups' tokens of the router probabilities and
    of the top-1 one-hots (the aux loss's two means)."""
    g, n, d = xt.shape
    dev = xt.device
    probs = torch.softmax(router_logits(xt, router_w), dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[..., :k], expert[..., :k]                # (g, n, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = torch.nn.functional.one_hot(expert[..., 0], e_n).to(
        torch.float32).mean(dim=(0, 1))

    eflat = expert.reshape(g, n * k)
    gflat = gate.reshape(g, n * k).to(xt.dtype)
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
    buf = torch.zeros((g, e_n * (cap + 1), d), dtype=xt.dtype, device=dev)
    buf.scatter_(1, (se * (cap + 1) + row)[..., None].expand(g, n * k, d),
                 gathered)
    buffer = buf.reshape(g, e_n, cap + 1, d)[:, :, :cap]        # (g, E, C, d)
    counts = expert_row_counts(starts, n * k, cap)
    return buffer, counts, se, sg, pos_c, keep, order, me, ce


def _experts(buffer, counts, w_up, w_gate, w_down, *, activation: str,
             cap_off: Optional[int] = None):
    """The expert FFN on the (g, E, C, d) buffer (BSRPlanes: one
    planes-kernel launch per matmul); ``counts`` are the whole buffer's
    kept rows per (g, E).  With ``cap_off`` the buffer is a shard of the
    capacity rows starting there."""
    if cap_off is not None:
        counts = torch.clamp(counts - cap_off, min=0,
                             max=buffer.shape[2]).to(torch.int32)
    if w_gate is not None:
        up = expert_matmul(buffer, w_up, row_counts=counts)
        h = expert_matmul(buffer, w_gate,
                          epilogue=Epilogue(activation=activation,
                                            multiplier=up),
                          row_counts=counts)
    else:
        h = expert_matmul(buffer, w_up, epilogue=Epilogue(activation=activation),
                          row_counts=counts)
    h = h.to(buffer.dtype)
    return expert_matmul(h, w_down, row_counts=counts).to(buffer.dtype)


def _combine(out_e, se, sg, pos_c, keep, order, *, k: int,
             cap_off: Optional[int] = None):
    """Each token's k slot outputs, gate-weighted and added in expert id
    order: (g, n, d).  With ``cap_off``, ``out_e`` (g, E, C', d) is the
    shard of capacity rows ``[cap_off, cap_off + C')`` and slots outside
    it add nothing."""
    g, e_n, cl, d = out_e.shape
    nk = se.shape[1]
    n = nk // k
    at, live = pos_c, keep
    if cap_off is not None:
        at = pos_c - cap_off
        live = keep & (at >= 0) & (at < cl)
        at = at.clamp(0, cl - 1)
    back = out_e.reshape(g, e_n * cl, d)
    per_slot = torch.gather(back, 1, (se * cl + at)[..., None].expand(g, nk, d))
    per_slot = per_slot * torch.where(live, sg, torch.zeros_like(sg))[..., None]
    # each token's k slots, by sorted position (= expert id order)
    inv = torch.argsort(order, dim=-1)
    tok_slots = torch.sort(inv.reshape(g, n, k), dim=-1).values.reshape(g, nk)
    vals = torch.gather(per_slot, 1, tok_slots[..., None].expand(g, nk, d))
    vals = vals.reshape(g, n, k, d)
    out = torch.zeros((g, n, d), dtype=out_e.dtype, device=out_e.device)
    for j in range(k):
        out = out + vals[:, :, j]
    return out


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
    xt = logical_constraint(x.reshape(g, n, d), "batch", None, "embed")
    route = functools.partial(_route, e_n=e_n, k=k, cap=cap)
    if not is_dtensor(xt):
        (buffer, counts, se, sg, pos_c, keep, order, me,
         ce) = route(xt, p["router"]["kernel"])
        out_e = _experts(buffer, counts, p["experts_up"], p.get("experts_gate"),
                         p["experts_down"], activation=activation)
        out = _combine(out_e, se, sg, pos_c, keep, order, k=k)
    else:
        (out, me, ce) = _moe_sharded(
            p, xt, route, e_n=e_n, k=k, cap=cap, activation=activation)
    aux = e_n * torch.sum(me * ce)
    return logical_constraint(out.reshape(b, s, d), "batch", "seq", "embed"), aux


def _moe_sharded(p, xt, route, *, e_n: int, k: int, cap: int, activation: str):
    """``moe_apply``'s three stages on DTensors, each on this rank's
    shards, as the reference's ``vmap`` over groups is local per data
    shard: the dispatch per group shard (replicated over "model"), the
    expert FFN with the capacity dim on "expert_cap" (or, under intra-
    expert TP, the expert weights' d_ff on "model"), the combine as a
    partial sum over the capacity shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    batch = batch_placements(xt)
    over_groups = tuple(Partial() if pl == Shard(0) else Replicate()
                        for pl in batch)
    rep = tuple(Replicate() for _ in batch)
    outs = (batch,) * 7 + (over_groups, over_groups)
    groups = xt.shape[0]

    def route_shard(x_l, w):
        # each shard's means weighted by its share of the groups: their
        # partial sum over the shards is the mean over all groups
        *rest, me, ce = route(x_l, w)
        share = x_l.shape[0] / groups
        return (*rest, me * share, ce * share)

    (buffer, counts, se, sg, pos_c, keep, order, me, ce) = shard_map(
        route_shard, in_placements=(batch, rep), out_placements=outs,
        in_grad_placements=(batch, over_groups))(xt, p["router"]["kernel"])

    cap_ax = "expert_cap" if _cap_sharded(e_n) else None
    buffer = logical_constraint(buffer, "batch", None, cap_ax, None)
    cap_off, _ = shard_extent(buffer, 2)
    ws = [p["experts_up"], p.get("experts_gate"), p["experts_down"]]
    buf_pl = tuple(buffer.placements)
    # FSDP'd dims gathered; intra-expert TP d_ff dims kept unless the
    # capacity dim is sharded over the same axis (the constraint wins)
    w_in = tuple(None if w is None else tuple(
        Replicate() if buf_pl[i] == Shard(2) else pl
        for i, pl in enumerate(gather_fsdp(w).placements)) for w in ws)
    f_sharded = [any(pl.is_shard() for pl in (w_in[0][i], w_in[2][i]))
                 for i in range(len(batch))]
    # the output, and the buffer's gradient, are partial sums over d_ff
    out_pl = tuple(Partial() if f_sharded[i] else buf_pl[i]
                   for i in range(len(batch)))
    w_grad = tuple(None if w is None else tuple(
        Partial() if buf_pl[i].is_shard() else w_in[j][i]
        for i in range(len(batch))) for j, w in enumerate(ws))
    experts = functools.partial(_experts, activation=activation, cap_off=cap_off)
    out_e = shard_map(
        experts, in_placements=(buf_pl, batch) + w_in, out_placements=out_pl,
        in_grad_placements=(out_pl, batch) + w_grad)(buffer, counts, *ws)
    out_e = logical_constraint(out_e, "batch", None, cap_ax, None)

    e_pl = tuple(out_e.placements)
    cap_split = [e_pl[i] == Shard(2) for i in range(len(batch))]
    summed = tuple(Partial() if cap_split[i] else batch[i] for i in range(len(batch)))
    combine = functools.partial(_combine, k=k, cap_off=shard_extent(out_e, 2)[0])
    out = shard_map(
        combine, in_placements=(e_pl,) + (batch,) * 5, out_placements=summed,
        in_grad_placements=(e_pl, batch, summed, batch, batch, batch))(
            out_e, se, sg, pos_c, keep, order)
    return out, me, ce


def moe_decode(p: Dict, x: torch.Tensor, *, num_experts: int, top_k: int,
               capacity_factor: float = 2.0,
               activation: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode path: the same dispatch over one group of the B tokens, at
    a generous capacity factor (token counts are tiny at decode: 4 tokens
    x top-8 fill 32 of granite's 32 x 8 capacity rows)."""
    return moe_apply(p, x, num_experts=num_experts, top_k=top_k,
                     capacity_factor=capacity_factor, groups=1,
                     activation=activation)
