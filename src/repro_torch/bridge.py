"""Carry reference (JAX) params into the port through numpy.

``params_from_reference(tree, device)`` walks nested dicts and lists and
turns every array leaf into a torch tensor with ``np.asarray`` — which
reads a JAX array without this module importing JAX.  A leaf that looks
like the reference's ``BSRPlanes`` (it carries ``plane_nnz``) becomes the
port's ``BSRPlanes``; one like its ``BSRWeight`` (``indices``, ``slots``,
``blocks``, ``flat_rows``, ``flat_cols``, ``shape``, ``blocking``,
``nnz_blocks``) the port's ``BSRWeight``, each with the identical
layout.  The planes test comes first: a ``BSRPlanes`` has every
``BSRWeight`` field too (``nnz_blocks`` is a property there).

``np.asarray`` of a bf16 JAX array has the ``ml_dtypes`` bfloat16 dtype,
which ``torch.from_numpy`` rejects: such leaves go through their raw
16-bit pattern (``.view(np.uint16)``) and are reinterpreted on the torch
side (``.view(torch.bfloat16)``), bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.packing import BSRPlanes, BSRWeight
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
    tensors (and ``BSRPlanes`` / ``BSRWeight`` leaves) on ``device``."""
    if all(hasattr(tree, f) for f in _BSR_FIELDS):
        b = tree.blocking
        arrays = {f: tensor_from_reference(getattr(tree, f), device)
                  for f in _BSR_FIELDS[:5]}
        common = dict(
            shape=tuple(int(s) for s in tree.shape),
            blocking=BlockingSpec(bk=b.bk, bn=b.bn, consecutive=b.consecutive))
        if hasattr(tree, "plane_nnz"):
            return BSRPlanes(**arrays, **common, plane_nnz=tuple(
                int(z) for z in tree.plane_nnz))
        return BSRWeight(**arrays, **common, nnz_blocks=int(tree.nnz_blocks))
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device) for v in tree)
    if tree is None:
        return None
    return tensor_from_reference(tree, device)
