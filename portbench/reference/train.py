"""Plain PyTorch reference of the port's masked fine-tune step (the
paper's Algorithm 2 fine-tunes under its knapsack's masks), in fp32 with
TF32 off, over :mod:`portbench.reference.decoder`'s weights.  It imports
nothing of ``repro_torch`` or ``repro``.

One step, as the port's train step states it: the forward over the
masked weights (each dropped tile zero), the token-mean cross-entropy
plus ``z_loss * mean(logsumexp^2)``, gradients of every weight (a
masked weight's gradient is zero where it is dropped), the global-norm
clip, then AdamW with fp32 masters (``m``, ``v``, bias correction by
the step count, decoupled weight decay on every weight), after which a
masked weight's master, ``m`` and ``v`` are zero where it is dropped.
The learning rate is warm-up then cosine, as ``optim.warmup_cosine``
states it, read at the step count before the update.

With ``fp8`` the forward reads every matrix rounded to fp8 e4m3 (one
scale per matrix; the gradient passes straight through): the control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from . import decoder

__all__ = ["warmup_cosine", "fine_tune", "leaf_norms"]


def warmup_cosine(step: int, peak: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> float:
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return final_frac * peak + (1 - final_frac) * peak * 0.5 * (1 + math.cos(math.pi * t))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1e-30)
    q = (x.detach() * (448.0 / amax)).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q * (amax / 448.0) - x.detach())


def _row_loss(w, tokens, labels, cfg, z_loss):
    """One row's token-mean loss."""
    logits = decoder._forward(w, tokens, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - ll) + z_loss * torch.mean(lse * lse)


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """L2 norm of each leaf: a stacked (L, ...) kind is one leaf per
    layer (``"wq/3"``), the embedding and the final norm one each."""
    out = {}
    for name, x in tree.items():
        if name in ("embed", "final_norm"):
            out[name] = float(torch.linalg.vector_norm(x.to(torch.float32)))
        else:
            n = torch.linalg.vector_norm(x.to(torch.float32).reshape(x.shape[0], -1),
                                         dim=1)
            out.update({f"{name}/{i}": float(v) for i, v in enumerate(n)})
    return out


def fine_tune(weights: Dict[str, torch.Tensor], keep: Dict[str, torch.Tensor],
              cfg: Dict, batches: List[Dict[str, torch.Tensor]], opt: Dict,
              lr: Dict, *, fp8: bool = False, z_loss: float = 1e-4) -> Dict:
    """``len(batches)`` masked AdamW steps from fresh state over
    ``weights`` (their dtype widened to fp32).  Returns each step's loss,
    the first step's clipped gradient by leaf, and the masters after the
    last step."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _fine_tune(weights, keep, cfg, batches, opt, lr, fp8, z_loss)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _fine_tune(weights, keep, cfg, batches, opt, lr, fp8, z_loss):
    tile = int(cfg["pruning"]["block"][0])
    masks = {k: decoder._expand(v, tile).to(torch.float32) for k, v in keep.items()}
    master = {k: v.detach().to(torch.float32).clone() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in master.items()}
    v2 = {k: torch.zeros_like(v) for k, v in master.items()}
    losses: List[float] = []
    first: Optional[Dict[str, torch.Tensor]] = None
    b1, b2 = float(opt["b1"]), float(opt["b2"])
    for step, batch in enumerate(batches):
        # the batch's loss is the mean of its rows' (every row has the
        # same length): one row's forward and backward at a time
        rows = batch["tokens"].shape[0]
        g = {k: torch.zeros_like(x) for k, x in master.items()}
        loss = 0.0
        for b in range(rows):
            leaves = {k: x.clone().requires_grad_(True) for k, x in master.items()}
            w = {}
            for k, x in leaves.items():
                x = x * masks[k] if k in masks else x
                w[k] = _fp8(x) if fp8 and x.ndim >= 2 and not k.endswith("norm") else x
            row = _row_loss(w, batch["tokens"][b], batch["labels"][b], cfg, z_loss)
            for k, gr in zip(leaves, torch.autograd.grad(row / rows,
                                                         list(leaves.values()))):
                g[k] += gr
            loss += float(row.detach()) / rows
            del leaves, w, row
        losses.append(loss)
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-12), max=1.0)
        g = {k: x * scale for k, x in g.items()}
        if first is None:
            first = {k: x.clone() for k, x in g.items()}
        count = step + 1
        b1c, b2c = 1.0 - b1 ** count, 1.0 - b2 ** count
        rate = warmup_cosine(step, lr["peak"], lr["warmup"], lr["total"])
        with torch.no_grad():
            for k in master:
                gk = g[k] * masks[k] if k in masks else g[k]
                m[k] = b1 * m[k] + (1 - b1) * gk
                v2[k] = b2 * v2[k] + (1 - b2) * gk * gk
                upd = (m[k] / b1c) / (torch.sqrt(v2[k] / b2c) + opt["eps"]) \
                    + opt["weight_decay"] * master[k]
                master[k] = master[k] - rate * upd
                if k in masks:
                    master[k] = master[k] * masks[k]
                    m[k] = m[k] * masks[k]
                    v2[k] = v2[k] * masks[k]
    return {"losses": losses, "first_grad": first, "master": master}
