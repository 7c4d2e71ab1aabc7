"""Carry reference (JAX) params into the port through numpy.

``params_from_reference(tree, device)`` walks nested dicts and lists and
turns every array leaf into a torch tensor with ``np.asarray`` — which
reads a JAX array without this module importing JAX.  A leaf that looks
like the reference's ``BSRWeight`` (``indices``, ``slots``, ``blocks``,
``flat_rows``, ``flat_cols``, ``shape``, ``blocking``, ``nnz_blocks``)
becomes the port's ``BSRWeight`` with the identical layout.

``np.asarray`` of a bf16 JAX array has the ``ml_dtypes`` bfloat16 dtype,
which ``torch.from_numpy`` rejects: such leaves go through their raw
16-bit pattern (``.view(np.uint16)``) and are reinterpreted on the torch
side (``.view(torch.bfloat16)``), bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.packing import BSRWeight
from repro_torch.core.structures import BlockingSpec

__all__ = ["params_from_reference", "tensor_from_reference"]

_BSR_FIELDS = ("indices", "slots", "blocks", "flat_rows", "flat_cols",
               "shape", "blocking", "nnz_blocks")


def tensor_from_reference(x, device=None) -> torch.Tensor:
    """One array (JAX or numpy) as a torch tensor on ``device``."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device) if device is not None else t


def params_from_reference(tree: Any, device=None) -> Any:
    """Nested dicts/lists of reference arrays -> the same tree of torch
    tensors (and ``BSRWeight`` leaves) on ``device``."""
    if all(hasattr(tree, f) for f in _BSR_FIELDS):
        b = tree.blocking
        return BSRWeight(
            indices=tensor_from_reference(tree.indices, device),
            slots=tensor_from_reference(tree.slots, device),
            blocks=tensor_from_reference(tree.blocks, device),
            flat_rows=tensor_from_reference(tree.flat_rows, device),
            flat_cols=tensor_from_reference(tree.flat_cols, device),
            shape=tuple(int(s) for s in tree.shape),
            blocking=BlockingSpec(bk=b.bk, bn=b.bn, consecutive=b.consecutive),
            nnz_blocks=int(tree.nnz_blocks),
        )
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device) for v in tree)
    if tree is None:
        return None
    return tensor_from_reference(tree, device)
