"""Expert-parallel MoE with an explicit all-to-all dispatch — torch port
of ``src/repro/models/moe_alltoall.py``.

Topology, as in the reference: tokens sharded over the data axes and
replicated over "model" (every model rank routes all ``t`` tokens of its
data shard, exactly as the reference's ``P(dp, None, None)`` input spec
replicates them); experts sharded over "model", ``E_loc = E / m`` per
rank.  Two-stage routing on each rank:

1. sort the (token, choice) slots by destination rank (stable), into
   fixed per-destination send buffers of ``c_send = max(ceil(t k cf / m),
   k)`` rows, dropping slots past them;
2. ``all_to_all`` the payload and the expert ids to the owning ranks;
3. sort the received rows by local expert (stable, invalid ids -1 last)
   into ``(E_loc, c_exp, d)`` buffers, ``c_exp = max(ceil(m c_send /
   E_loc), 1)``, dropping rows past them, and run the expert FFN;
4. gather back, ``all_to_all`` home and combine with the gates.

The code is per-rank SPMD: each rank runs ``moe_alltoall_apply`` on its
data shard's tokens with the full or its own shard of the expert
weights (``sparse.shard_experts``), and the collectives run on the
installed mesh's per-axis process groups (``distributed.use_mesh``).
Differences from the reference, for torch:

* the reference's scatter-adds ``.at[].add(mode="drop")`` put each
  kept slot at its own row and add zeros at row 0 for the rest; here a
  kept slot is copied to its row and the rest to a scratch row that is
  sliced off (``_place_rows``): the same buffer, without the thousands
  of duplicate row-0 indices that serialise CUDA's accumulating
  ``index_put``.  ``.at[].max`` is ``scatter_reduce_("amax")``;
* top-k is a stable descending sort and every dispatch sort is stable,
  so the same slots drop; router logits are ``moe.router_logits``'s
  exact fp32 products; the combine adds each token's k slot outputs in
  their dispatch order in a fixed loop, like ``moe.moe_apply``;
* the expert FFN is ``layers.expert_matmul`` on the local buffers, one
  planes-kernel launch per matmul on ``BSRPlanes`` leaves with
  ``act(gate) * up`` in the epilogue, each local expert's fill passed
  as row counts (rows past it are zero rows, so results are unchanged);
* the aux loss's ``pmean`` over each data axis is an all-reduce SUM over
  that axis's group divided by its size (gloo has no ``AVG``);
* under slot drops the model ranks' y differ: each expert rank fills its
  buffers with source 0's rows before source 1's, so later sources'
  copies of a token drop first.  The reference declares y replicated
  anyway (``out_specs`` with ``check=False``) and its global y is model
  index 0's; here every rank takes model rank 0's y (a broadcast over
  the model group), so the replicas agree and equal that global y;
* gradients: the all-to-all's backward is the same all-to-all, and the
  replication over "model" is made explicit so that each rank's gradient
  is the global one that the reference's ``shard_map`` transpose gives
  on that device, with every rank back-propagating its (replicated)
  loss: a model-replicated input (x, the router) sums its gradient over
  the model group, a model-replicated output (y, aux) passes 1/m of its
  cotangent, the broadcast sums y's cotangents onto model rank 0, and a
  data-axis mean passes 1/n of it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_mesh, current_rules
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.sparse.transform import shard_experts
from .layers import expert_matmul
from .moe import router_logits

__all__ = ["moe_alltoall_apply", "alltoall_available"]


def alltoall_available(num_experts: int) -> bool:
    """The all-to-all path applies under a mesh with a "model" axis and a
    rule set, when the experts split evenly over that axis."""
    mesh = current_mesh()
    if mesh is None or current_rules() is None \
            or "model" not in (mesh.mesh_dim_names or ()):
        return False
    return num_experts % mesh["model"].size() == 0


class _AllToAll(torch.autograd.Function):
    """Equal splits over dim 0 on ``group``: source j's chunk lands at
    index j (``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``).  Its
    transpose is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _ReplicatedIn(torch.autograd.Function):
    """Identity on a value replicated over ``group``; the gradient sums
    the ranks' partial gradients over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReplicatedOut(torch.autograd.Function):
    """Identity on a value replicated over n ranks that each put it in
    their loss: each passes 1/n of the cotangent."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _FromFirst(torch.autograd.Function):
    """Every rank of ``group`` takes its rank 0's value; the cotangents
    sum onto rank 0 (zero on the others)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        if dist.get_rank(ctx.group) != 0:
            g = torch.zeros_like(g)
        return g, None


class _MeanOver(torch.autograd.Function):
    """``pmean`` over ``group``: all-reduce SUM divided by the group's
    size; the result is replicated, so the cotangent passes 1/n."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.n = n
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _place_rows(rows: int, idx: torch.Tensor, keep: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """(rows, d) zeros with ``vals[i]`` at row ``idx[i]`` for each kept
    i (kept rows are distinct); the others land in a scratch row that
    is sliced off."""
    dest = torch.where(keep, idx, torch.full_like(idx, rows))
    buf = torch.zeros((rows + 1, vals.shape[-1]), dtype=vals.dtype,
                      device=vals.device)
    return buf.index_copy(0, dest, vals)[:rows]


def _expert_ffn(ebuf: torch.Tensor, p: Dict, activation: str,
                counts) -> torch.Tensor:
    """The local expert FFN on (E_loc, C, d) buffers, fp32 out, with the
    activation (and SwiGLU gate) fused into the up/gate epilogue; each
    matmul sees the (E_loc,) row ``counts`` (None: every row live)."""
    h = ebuf[None]                                           # (1, E_loc, C, d)
    rc = None if counts is None else counts[None]
    if "experts_gate" in p:
        up = expert_matmul(h, p["experts_up"], row_counts=rc)
        a = expert_matmul(h, p["experts_gate"], row_counts=rc,
                          epilogue=Epilogue(activation=activation, multiplier=up))
    else:
        a = expert_matmul(h, p["experts_up"], row_counts=rc,
                          epilogue=Epilogue(activation=activation))
    return expert_matmul(a.to(ebuf.dtype), p["experts_down"], row_counts=rc)[0]


def _local_moe(x_loc: torch.Tensor, p: Dict, *, num_experts: int, top_k: int,
               capacity_factor: float, activation: str, group, model_size: int,
               dp_groups) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank body (reference :68-155).  x_loc (T, d) tokens of this
    rank's data shard; p holds this rank's E_loc experts."""
    t, d = x_loc.shape
    m, k = model_size, top_k
    e_loc = num_experts // m
    c_send = max(int(math.ceil(t * k * capacity_factor / m)), k)
    c_exp = max(int(math.ceil(m * c_send / e_loc)), 1)
    dev, dt = x_loc.device, x_loc.dtype
    zero = torch.zeros((), dtype=dt, device=dev)

    # --- routing ------------------------------------------------------------
    probs = torch.softmax(router_logits(x_loc, p["router"]["kernel"]), dim=-1)
    gate, eid = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = gate[:, :k], eid[:, :k]                      # (T, k)
    gate = (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)).to(dt)

    # Switch aux loss, averaged over the token shards
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(eid[:, 0], num_experts).to(
        torch.float32).mean(dim=0)
    for g in dp_groups:
        me = _MeanOver.apply(me, g)
        ce = _MeanOver.apply(ce, g)
    aux = num_experts * torch.sum(me * ce)

    # --- stage 1: sort by destination rank -----------------------------------
    ef = eid.reshape(-1)                                     # (T*k,)
    gf = gate.reshape(-1)
    slots = torch.arange(t * k, device=dev)
    dest = ef // e_loc
    order = torch.argsort(dest, stable=True)
    sd, se_, sg, stok = dest[order], ef[order], gf[order], order // k
    starts = torch.searchsorted(sd, torch.arange(m, device=dev))
    pos = slots - starts[sd]
    keep = pos < c_send
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    send_x = _place_rows(m * c_send, sd * c_send + pos, keep,
                         x_loc[stok]).reshape(m, c_send, d)
    send_id = torch.full((m * c_send,), -1, dtype=torch.int64, device=dev)
    send_id.scatter_reduce_(0, sd * c_send + pos_c,
                            torch.where(keep, se_, torch.full_like(se_, -1)),
                            reduce="amax")

    # --- stage 2: to the expert ranks -----------------------------------------
    rx = _AllToAll.apply(send_x, group).reshape(m * c_send, d)
    rid = _all_to_all(send_id.reshape(m, c_send), group).reshape(m * c_send)

    # --- stage 3: local per-expert buffers ------------------------------------
    valid = rid >= 0
    le_sort = torch.where(valid, rid % e_loc, torch.full_like(rid, e_loc))
    order2 = torch.argsort(le_sort, stable=True)
    le2, valid2 = le_sort[order2], valid[order2]
    experts = torch.arange(e_loc + 1, device=dev)
    bounds = torch.searchsorted(le2, experts)                # starts, n valid
    starts2 = bounds[:-1]
    pos2 = torch.arange(m * c_send, device=dev) - starts2[
        torch.clamp(le2, 0, e_loc - 1)]
    keep2 = valid2 & (pos2 < c_exp)
    pos2c = torch.where(keep2, pos2, torch.zeros_like(pos2))
    le2c = torch.where(keep2, le2, torch.zeros_like(le2))
    ebuf = _place_rows(e_loc * c_exp, le2c * c_exp + pos2c, keep2,
                       rx[order2]).reshape(e_loc, c_exp, d)
    # each local expert's kept rows fill [0, count) of its buffer
    counts = torch.clamp(bounds[1:] - starts2, max=c_exp).to(torch.int32)

    out_e = _expert_ffn(ebuf, p, activation, counts).to(dt)  # (E_loc, C, d)

    # --- stage 4: inverse route back -------------------------------------------
    y_sorted = torch.where(keep2[:, None], out_e[le2c, pos2c], zero)
    inv2 = torch.empty_like(order2).scatter_(
        0, order2, torch.arange(m * c_send, device=dev))
    y_send = _AllToAll.apply(y_sorted[inv2].reshape(m, c_send, d), group)
    y_slot = torch.where(keep[:, None], y_send[sd, pos_c], zero) * sg[:, None]
    # each token's k slots, added in dispatch order
    inv = torch.empty_like(order).scatter_(0, order, slots)
    tok_slots = torch.sort(inv.reshape(t, k), dim=-1).values
    vals = y_slot[tok_slots]                                  # (T, k, d)
    out = torch.zeros((t, d), dtype=dt, device=dev)
    for j in range(k):
        out = out + vals[:, j]
    return out, aux


def moe_alltoall_apply(
    p: Dict,
    x: torch.Tensor,               # (B, S, D): this rank's data shard
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x.dtype, aux loss scalar fp32) under
    the installed mesh and rules (``alltoall_available``).  ``p`` holds
    all ``num_experts`` experts (this rank's are sliced out, as views)
    or only this rank's ``E / m``."""
    mesh = current_mesh()
    rules = current_rules()
    dp = rules.get("batch") or ()
    dp_axes = (dp,) if isinstance(dp, str) else tuple(dp)
    sub = mesh["model"]
    m = sub.size()
    group = sub.get_group()
    e = int(p["experts_up"].shape[0])
    if e == num_experts:
        p = shard_experts(p, sub.get_local_rank(), m)
    elif e != num_experts // m:
        raise ValueError(f"moe_alltoall_apply: {e} expert planes are neither "
                         f"all {num_experts} nor this rank's {num_experts // m}")
    p = {**p, "router": {"kernel": _ReplicatedIn.apply(p["router"]["kernel"],
                                                       group)}}
    b, s, d = x.shape
    y, aux = _local_moe(
        _ReplicatedIn.apply(x, group).reshape(b * s, d), p,
        num_experts=num_experts, top_k=top_k, capacity_factor=capacity_factor,
        activation=activation, group=group, model_size=m,
        dp_groups=[mesh.get_group(ax) for ax in dp_axes])
    y = y.reshape(b, s, d)
    if m > 1:
        y = _FromFirst.apply(y, group)
    return _ReplicatedOut.apply(y, m), _ReplicatedOut.apply(aux, m)
