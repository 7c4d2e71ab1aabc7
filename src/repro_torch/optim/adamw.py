"""AdamW with fp32 state, optional fp32 master weights and mask-aware
updates, torch port of ``src/repro/optim/adamw.py``.

Plain tensor ops over the params tree (no ``torch.optim``), in the
reference's arithmetic order, so an update fed the same gradients gives
the same numbers.  State layout mirrors the params tree:

    {"m": fp32, "v": fp32, "master": fp32 (optional), "count": () int32}

Masking (paper Alg. 2 fine-tuning): the forward uses ``params * mask``,
so gradients of pruned entries are already zero, but weight decay and
the moments would drift them off zero; the update, ``m`` and ``v`` are
therefore masked again.  ``adamw_update`` is functional: it returns
new tensors and leaves its inputs as they were.  ``adamw_update_`` is
its in-place form for a captured train step: the same update, written
back into the given params and state.  Neither makes a host-to-device
copy, so both run under a CUDA graph capture.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.masks import copy_tree_, map_tree, tree_leaves

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "adamw_update_",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    use_master: bool = True     # fp32 master copies for bf16 params


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32)

    first = tree_leaves(params)[0]
    state = {
        "m": map_tree(zeros32, params),
        "v": map_tree(zeros32, params),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }
    if cfg.use_master:
        state["master"] = map_tree(lambda p: p.to(torch.float32).clone(), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares (leaves in the
    reference's pytree order)."""
    leaves = [torch.sum(torch.square(g.to(torch.float32)))
              for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return map_tree(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def adamw_update(
    params,
    grads,
    state: Dict[str, Any],
    cfg: AdamWConfig,
    lr,
    masks: Optional[Mapping[str, Any]] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step.  ``lr`` is a float or an fp32 scalar tensor.
    Returns (new_params, new_state)."""
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    cf = count.to(torch.float32)
    # the bases are filled on the device (a ``torch.tensor`` of a Python
    # float would be a host-to-device copy, which a capture refuses)
    b1c = 1.0 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32,
                                     device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32,
                                     device=cf.device), cf)

    def upd(p, g, m, v, master, mask):
        gf = g.to(torch.float32)
        mk = None if mask is None else mask.to(torch.float32)
        if mk is not None:
            gf = gf * mk
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
        mh = m / b1c
        vh = v / b2c
        base = master if master is not None else p.to(torch.float32)
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * base
        new_master = base - lr * step
        if mk is not None:
            new_master = new_master * mk
            m = m * mk
            v = v * mk
        return _Leaf(new_master.to(p.dtype), m, v, new_master)

    none = map_tree(lambda _: None, params)
    out = map_tree(upd, params, grads, state["m"], state["v"],
                   state.get("master", none),
                   masks if masks is not None else none)
    new_state = {"m": map_tree(lambda r: r.m, out),
                 "v": map_tree(lambda r: r.v, out), "count": count}
    if "master" in state:
        new_state["master"] = map_tree(lambda r: r.master, out)
    return map_tree(lambda r: r.param, out), new_state


def adamw_update_(
    params,
    grads,
    state: Dict[str, Any],
    cfg: AdamWConfig,
    lr,
    masks: Optional[Mapping[str, Any]] = None,
) -> None:
    """``adamw_update`` in place: the new params, ``m``, ``v``,
    ``master`` and ``count`` are copied into the tensors of ``params``
    and ``state``, which keep their storage (a CUDA graph replays over
    them).  The numbers are ``adamw_update``'s, bit for bit."""
    new_params, new_state = adamw_update(params, grads, state, cfg, lr, masks=masks)
    copy_tree_(params, new_params)
    copy_tree_(state, new_state)


@dataclasses.dataclass
class _Leaf:
    """One leaf's update (a tree leaf, where a tuple would be a node)."""

    param: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    master: torch.Tensor
