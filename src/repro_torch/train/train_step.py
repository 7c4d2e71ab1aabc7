"""Train / prefill / decode step builders, torch port of
``src/repro/train/train_step.py``.

``make_train_step`` returns a (state, batch) -> (state, metrics) function
with:

* a mask-aware forward (``params * mask``, so pruned structures
  contribute zero and receive zero gradient: the paper's fine-tuning);
* optional resource-aware group-lasso regularization (``reg_fn``, applied
  to the unmasked params as in the reference);
* microbatched gradient accumulation;
* AdamW with fp32 state and global-norm clipping;
* the MoE aux loss folded into the total.

Gradients come from ``torch.autograd.grad`` over fresh leaves of the
params, so the step is functional like the reference's: the input state
is left as it was and a new one is returned.  The reference compiles the
step with ``jax.jit``; here ``make_train_step`` runs op by op, and
``make_train_body`` is the same step in place, which
``train.graphs.GraphedTrainStep`` captures as one CUDA graph and runs
with the functional contract.

Sharded state: the three steps take a state of DTensors (placed by
``launch.specs.cell_shardings`` through ``distributed.distribute_tree``)
under an installed mesh and rules, and return it with the same
placements; each gradient is brought to its parameter's placements
before the update, and masked AdamW and the global-norm clip then run
over the shards (the norm's per-leaf sums reduce across them).  Plain
tensors the model makes itself count as replicated there: each step
runs under DTensor's ``implicit_replication``, entered once at its
boundary.

State: {"params", "opt", "masks" (optional), "step" () int32}.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.masks import apply_masks, map_tree, tree_leaves
from repro_torch.distributed.sharding import is_dtensor, reduce_partial
from repro_torch.models.transformer import (
    cross_entropy_loss,
    lm_decode,
    lm_forward,
)
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    adamw_update_,
    init_opt_state,
)

__all__ = ["make_train_step", "make_train_body", "make_prefill_step",
           "make_decode_step", "init_train_state"]


def init_train_state(params, opt_cfg: AdamWConfig, masks=None) -> Dict[str, Any]:
    dev = tree_leaves(params)[0].device
    with tracing.span("train.init_state"):
        state = {
            "params": params,
            "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }
    if masks is not None:
        state["masks"] = masks
    return state


def _make_grads(cfg: ModelConfig, reg_fn: Optional[Callable],
                moe_aux_weight: float, microbatches: int) -> Callable:
    """``grads_of(state, batch) -> (grads, metrics)``: the loss and its
    gradients (averaged over ``microbatches``), with the metrics
    ``loss``, ``moe_aux`` and ``total_loss`` as device scalars."""
    def loss_fn(params, masks, batch):
        p = apply_masks(params, masks) if masks is not None else params
        logits, aux = lm_forward(p, batch, cfg)
        xent = reduce_partial(cross_entropy_loss(logits, batch["labels"]))
        total = reduce_partial(xent + moe_aux_weight * aux["moe_aux"])
        if reg_fn is not None:
            total = total + reg_fn(params)
        return total, {"loss": xent.detach(), "moe_aux": aux["moe_aux"].detach()}

    def grad_fn(params, masks, batch):
        """((total, metrics), grads) with grads a tree like params (a
        DTensor gradient placed as its parameter)."""
        with torch.enable_grad():
            leaves = []

            def fresh(t):
                leaf = t.detach().requires_grad_(True)
                leaves.append(leaf)
                return leaf

            live = map_tree(fresh, params)
            total, metrics = loss_fn(live, masks, batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter(zip(leaves, grads))

        def grad_of(_):
            leaf, g = next(it)
            if g is None:
                return torch.zeros_like(leaf)
            if is_dtensor(g) and g.placements != leaf.placements:
                g = g.redistribute(leaf.device_mesh, leaf.placements)
            return g

        return (total.detach(), metrics), map_tree(grad_of, live)

    def grads_of(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        masks = state.get("masks")

        if microbatches <= 1:
            (total, metrics), grads = grad_fn(params, masks, batch)
        else:
            b = batch["tokens"].shape[0]
            mb = b // microbatches
            grads = None
            dev = batch["tokens"].device
            total = torch.zeros((), dtype=torch.float32, device=dev)
            metrics = {"loss": torch.zeros((), dtype=torch.float32, device=dev),
                       "moe_aux": torch.zeros((), dtype=torch.float32, device=dev)}
            for i in range(microbatches):
                sl = {k: v[i * mb: (i + 1) * mb] for k, v in batch.items()}
                (t_i, m_i), g_i = grad_fn(params, masks, sl)
                total = total + t_i / microbatches
                metrics = {k: metrics[k] + m_i[k] / microbatches for k in metrics}
                grads = g_i if grads is None else map_tree(
                    lambda a, b_: a + b_, grads, g_i)
            grads = map_tree(lambda g: g / microbatches, grads)
        metrics = dict(metrics)
        metrics["total_loss"] = total
        return grads, metrics

    return grads_of


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    lr_schedule: Callable[[Any], torch.Tensor],
    *,
    reg_fn: Optional[Callable] = None,
    moe_aux_weight: float = 0.01,
    microbatches: int = 1,
) -> Callable:
    """The functional step ``(state, batch) -> (new state, metrics)``;
    the metrics are ``loss``, ``moe_aux``, ``total_loss`` and ``lr``."""
    grads_of = _make_grads(cfg, reg_fn, moe_aux_weight, microbatches)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        with implicit_replication():
            grads, metrics = grads_of(state, batch)
            masks = state.get("masks")
            lr = lr_schedule(state["step"])
            new_params, new_opt = adamw_update(
                state["params"], grads, state["opt"], opt_cfg, lr, masks=masks)
            new_state = {
                "params": new_params,
                "opt": new_opt,
                "step": state["step"] + 1,
            }
            if masks is not None:
                new_state["masks"] = masks
            metrics["lr"] = lr
            return new_state, metrics

    return train_step


def make_train_body(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    lr_schedule: Callable[[Any], torch.Tensor],
    *,
    reg_fn: Optional[Callable] = None,
    moe_aux_weight: float = 0.01,
    microbatches: int = 1,
) -> Callable:
    """``make_train_step``'s step in place, the body a CUDA graph
    captures (``train.graphs.GraphedTrainStep``): ``train_body(state,
    batch) -> metrics`` writes the new params, optimizer state and step
    into ``state``'s own tensors (the masks are read only) and returns
    the metrics as device scalars.  The numbers are ``make_train_step``'s,
    bit for bit, and the body makes no host-to-device copy and reads
    nothing back to the host."""
    grads_of = _make_grads(cfg, reg_fn, moe_aux_weight, microbatches)

    def train_body(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        with implicit_replication():
            grads, metrics = grads_of(state, batch)
            lr = lr_schedule(state["step"])
            adamw_update_(state["params"], grads, state["opt"], opt_cfg, lr,
                          masks=state.get("masks"))
            state["step"].add_(1)
            metrics["lr"] = lr
            return metrics

    return train_body


def _last_position(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits of the last position, a DTensor's vocab gathered
    (DTensor has no cross-shard argmax)."""
    last = logits[:, -1, :]
    if is_dtensor(last):
        from torch.distributed.tensor import Replicate
        last = last.redistribute(last.device_mesh, tuple(
            Replicate() if p.is_shard(1) else p for p in last.placements))
    return last


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Inference prefill: forward to logits (no labels, no backward);
    returns the last position's greedy token."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with implicit_replication():
            logits, _ = lm_forward(params, batch, cfg)
            return torch.argmax(_last_position(logits), dim=-1)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, greedy: bool = True) -> Callable:
    """One new token with existing caches, the argmax.  ``greedy`` is
    read by neither this nor the reference's ``make_decode_step``; it is
    kept so that the two take the same arguments."""

    @torch.no_grad()
    def decode_step(params, caches, batch, cache_len):
        with implicit_replication():
            logits, caches = lm_decode(params, caches, batch, cache_len, cfg)
            next_tok = torch.argmax(_last_position(logits), dim=-1).to(torch.int32)
        return next_tok, caches

    return decode_step
