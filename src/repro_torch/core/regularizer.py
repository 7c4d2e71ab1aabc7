"""Resource-aware group regularization (paper §III-C, after Wen et al.),
torch port of ``src/repro/core/regularizer.py``.

A group-lasso penalty whose groups are the hardware resource structures:
the sum over structures of each structure's L2 norm, scaled by its
resource cost, so gradient steps shrink whole tiles toward zero together
and the knapsack's next selection finds near-zero tiles cheap to drop.
Differentiable through ``structure_norms_dense``.  As in the reference,
the gradient of a structure whose norm is exactly zero is NaN (the
derivative of ``sqrt`` at 0); no epsilon is added.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .masks import _get_path
from .resource_model import TPUResourceModel
from .structures import LayerStructures, structure_norms_dense

__all__ = ["group_lasso", "make_regularizer"]


def _structure_scales(structures: LayerStructures,
                      resource_model: Optional[TPUResourceModel]) -> list:
    """Each layer's ``cost_i / sqrt(|w_i|)`` (host floats)."""
    scales = []
    for info in structures.infos:
        if resource_model is not None:
            cost = float(np.sum(resource_model.structure_cost(info.blocking)))
        else:
            cost = 1.0
        # group-lasso scaling by sqrt(group size): comparable across blockings
        scales.append(float(cost / np.sqrt(info.block_elems)))
    return scales


def _weighted_norms(params: Mapping[str, Any], structures: LayerStructures,
                    scales: list, strength: float) -> torch.Tensor:
    total = None
    for info, scale in zip(structures.infos, scales):
        w = _get_path(params, info.path)
        norms = structure_norms_dense(w, info)  # (planes, gk, gn) fp32
        term = scale * torch.sum(norms)
        total = term if total is None else total + term
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return strength * total


def group_lasso(
    params: Mapping[str, Any],
    structures: LayerStructures,
    *,
    resource_model: Optional[TPUResourceModel] = None,
    strength: float = 1e-4,
) -> torch.Tensor:
    """sum_i  lambda * cost_i * ||w_i||_2 / sqrt(|w_i|)  over structures."""
    return _weighted_norms(params, structures,
                           _structure_scales(structures, resource_model), strength)


def make_regularizer(structures: LayerStructures, resource_model=None,
                     strength: float = 1e-4):
    """params -> scalar penalty (``group_lasso``, its per-layer scales
    computed once here rather than in every step)."""
    scales = _structure_scales(structures, resource_model)

    def reg(params):
        return _weighted_norms(params, structures, scales, strength)

    return reg
