"""Per-layer rematerialization policies — the counterpart of the
reference's ``_remat_wrap`` (``src/repro/models/transformer.py:297``).

``cfg.remat`` names the policy of ``torch.utils.checkpoint`` (always
non-reentrant) around each layer of ``lm_forward``:

* "none": no checkpoint; the backward keeps every activation autograd
  saves.
* "dots": selective checkpointing with ``dots_policy``, the counterpart
  of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
  outputs of the products without batch dims (the projections, in fp32,
  and the router's logits) are kept, everything else (the norms, RoPE,
  the widening casts, attention's batched products, the expert einsums,
  the recurrences, the collectives) is recomputed.
* "full" and any other name: the reference's ``nothing_saveable``, only
  the layer's inputs are kept.

Which op is such a product is read at dispatch (``_unbatched``):
``aten.mm``/``addmm``/``mv``/``dot`` (``torch.matmul`` of (..., K) @ (K,
N) folds to ``mm``) and a ``bmm``/``baddbmm`` whose batch has extent 1,
which is how ``torch.einsum`` lowers a contraction with no batch dims.
A ``bmm`` over a real batch (attention's scores and values, the expert
einsum, Mamba's read-out) is recomputed.  A batched product whose batch
has extent 1 (one row of one K/V head) cannot be told from an unbatched
one there and is kept.  The router's logits are an elementwise product
and a sum (batch-invariant routing, ``moe.router_logits``), so their
reduction runs under ``saved_product()``, which marks the ops inside as
one product to keep.

Under a ``TorchDispatchMode`` entered before the checkpoint (the
dry-run's ``CostCounter`` under ``FakeTensorMode``), the selective mode
sits inside it: a kept product is counted once, in the forward, and
stays live (the cache holds an alias of its storage) until the layer's
backward.  On DTensors the policy sees the DTensor ops, so a kept output
is the DTensor as placed, never gathered.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.utils.checkpoint

__all__ = ["dots_policy", "saved_product", "remat_context"]

_UNBATCHED = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.mv,
              torch.ops.aten.dot)
_BATCHED = (torch.ops.aten.bmm, torch.ops.aten.baddbmm)
_MARK = threading.local()


def _unbatched(op, args) -> bool:
    """Whether ``op`` on ``args`` is a product with no batch dims."""
    packet = getattr(op, "_overloadpacket", None)
    if packet in _UNBATCHED:
        return True
    if packet in _BATCHED:
        lhs = args[1] if packet is torch.ops.aten.baddbmm else args[0]
        return lhs.shape[0] == 1
    return False


@contextlib.contextmanager
def saved_product():
    """Marks the ops run inside as the last step of a product without
    batch dims that is not a matmul: "dots" keeps their outputs."""
    prev = getattr(_MARK, "on", False)
    _MARK.on = True
    try:
        yield
    finally:
        _MARK.on = prev


def dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of the products without batch dims, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    if getattr(_MARK, "on", False) or _unbatched(op, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(remat: str):
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for the
    policy named ``remat`` (not "none").  "dots" raises if selective
    checkpointing is missing from this torch: it never falls back to
    recomputing everything."""
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        return functools.partial(create_selective_checkpoint_contexts,
                                 dots_policy)
    return torch.utils.checkpoint.noop_context_fn
