"""Iterative resource-aware pruning, the paper's Algorithm 2, torch port
of ``src/repro/core/pruner.py``.

    identify structures W = {w_1..w_n}
    R_B <- sum R(w_i);  b <- evaluate(N; W, D_val)
    while s <= s_T and p >= (1 - tol) * b:
        v_i  <- ||w_i|| / max_{w_j in layer} ||w_j||
        solve MDKP(v, U, (1-s) ⊙ R_B)  ->  selected set Ŵ
        fine-tune N(Ŵ) with group regularization
        p <- evaluate;  s <- f(s)

The loop, the schedule and the knapsack run on the host (numpy); the
structure norms, masks and fine-tuning run on the params' device.
``finetune_fn`` and ``eval_fn`` are injected.  The structure norms come
from ``structure_norms_dense``, as in the reference's pruner, whose
values the knapsack sees; the cost vectors are the reference's
``TPUResourceModel``, so both packages make the same selection.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Mapping, Union

import numpy as np
import torch

from repro_torch import tracing

from .knapsack import KnapsackResult, solve_mdkp
from .masks import (
    _get_path, init_masks, masks_from_knapsack, sparsity_report, tree_leaves,
)
from .resource_model import TPUResourceModel
from .schedule import SparsitySchedule
from .structures import LayerStructures, structure_norms_dense

logger = logging.getLogger("repro_torch.pruner")

__all__ = ["PruneConfig", "PruneIterationLog", "IterativePruner"]

ResourceModels = Union[TPUResourceModel, Mapping[str, TPUResourceModel]]


def _settled(tree) -> float:
    """``time.time()`` once the card has finished the work queued for the
    tree's CUDA tensors, so the iteration's split times device work too."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    return time.time()


@dataclasses.dataclass
class PruneConfig:
    schedule: SparsitySchedule
    tolerance: float = 0.02          # paper: stop when acc drops > 2% relative
    exclude_zero: bool = True        # never re-select dead structures
    max_iters: int = 100
    higher_is_better: bool = True    # eval metric direction (accuracy vs loss)


@dataclasses.dataclass
class PruneIterationLog:
    iteration: int
    sparsity: np.ndarray
    metric: float
    knapsack_value: float
    knapsack_method: str
    resources_used: np.ndarray
    resources_baseline: np.ndarray
    structure_sparsity: float
    weight_sparsity: float
    seconds: float
    knapsack_seconds: float = 0.0    # scoring, MDKP and mask expansion
    finetune_seconds: float = 0.0    # finetune_fn

    def reduction(self) -> np.ndarray:
        """Paper-style 'X x' reduction factors per resource."""
        with np.errstate(divide="ignore"):
            return np.where(
                self.resources_used > 0,
                self.resources_baseline / np.maximum(self.resources_used, 1e-300),
                np.inf,
            )


class IterativePruner:
    """Drives Algorithm 2 over a params tree."""

    def __init__(
        self,
        structures: LayerStructures,
        resource_models: ResourceModels,
        config: PruneConfig,
    ):
        self.structures = structures
        self.config = config
        self._models = resource_models
        self._weights = self._build_weight_matrix()
        self._baseline = self._weights.sum(axis=1)

    # -- resource side ------------------------------------------------------

    def model_for(self, path: str) -> TPUResourceModel:
        if isinstance(self._models, TPUResourceModel):
            return self._models
        return self._models.get(path, self._models.get("default"))

    def _build_weight_matrix(self) -> np.ndarray:
        """U: (m, n) resource consumption per structure (static)."""
        cols: List[np.ndarray] = []
        for info in self.structures.infos:
            cost = self.model_for(info.path).structure_cost(info.blocking)
            cols.append(np.tile(cost[:, None], (1, info.num_structures)))
        if not cols:
            return np.zeros((2, 0))
        return np.concatenate(cols, axis=1)

    @property
    def baseline_resources(self) -> np.ndarray:
        return self._baseline

    # -- value side ----------------------------------------------------------

    def values(self, params: Mapping[str, Any]) -> np.ndarray:
        """Layer-normalized structure magnitudes (paper Eq. 4)."""
        vals: List[np.ndarray] = []
        for info in self.structures.infos:
            w = _get_path(params, info.path)
            norms = structure_norms_dense(w.detach(), info).cpu().numpy().reshape(-1)
            denom = float(norms.max()) if norms.size else 1.0
            vals.append(norms / max(denom, 1e-12))
        return np.concatenate(vals) if vals else np.zeros(0)

    # -- one knapsack step ---------------------------------------------------

    def prune_step(
        self, params: Mapping[str, Any], sparsity: np.ndarray
    ) -> tuple[Dict[str, Any], KnapsackResult]:
        with tracing.span("pruner.values"):
            values = self.values(params)
        capacity = (1.0 - np.asarray(sparsity)) * self._baseline
        weights = self._weights
        if self.config.exclude_zero:
            dead = values <= 1e-12
            values = np.where(dead, 0.0, values)
            # a dead structure gets a weight larger than any capacity, so
            # no solver path can select it
            weights = np.where(dead[None, :], capacity.max() * 2 + 1.0, weights)
        with tracing.span("pruner.solve"):
            result = solve_mdkp(values, weights, capacity)
        with tracing.span("pruner.masks"):
            masks = masks_from_knapsack(params, self.structures,
                                        result.x.astype(np.float32))
        # report true resource usage (without the exclusion inflation)
        result.used = self._weights @ result.x
        return masks, result

    # -- full loop -------------------------------------------------------------

    def run(
        self,
        params: Mapping[str, Any],
        finetune_fn: Callable[[Mapping[str, Any], Mapping[str, Any]], Mapping[str, Any]],
        eval_fn: Callable[[Mapping[str, Any], Mapping[str, Any]], float],
    ) -> tuple[Mapping[str, Any], Dict[str, Any], List[PruneIterationLog]]:
        """Returns (params, masks, logs).  Rolls back to the last state
        within tolerance if the final iteration broke the metric budget."""
        cfg = self.config
        masks = init_masks(params, self.structures)
        with tracing.span("pruner.eval"):
            baseline_metric = float(eval_fn(params, masks))
        sign = 1.0 if cfg.higher_is_better else -1.0
        bound = baseline_metric - sign * cfg.tolerance * abs(baseline_metric)

        logs: List[PruneIterationLog] = []
        s = np.zeros_like(np.asarray(cfg.schedule.target, dtype=np.float64))
        best = (params, masks)
        for it in range(cfg.max_iters):
            if cfg.schedule.reached(s):
                break
            with tracing.span("pruner.iteration", arg=it):
                s = cfg.schedule(s, it)
                t0 = _settled(params)
                with tracing.span("pruner.knapsack"):
                    masks, result = self.prune_step(params, s)
                    t1 = _settled(masks)
                with tracing.span("pruner.finetune"):
                    params = finetune_fn(params, masks)
                    t2 = _settled(params)
                with tracing.span("pruner.eval"):
                    metric = float(eval_fn(params, masks))
                with tracing.span("pruner.report"):
                    rep = sparsity_report(params, masks, self.structures)
                    logs.append(
                        PruneIterationLog(
                            iteration=it,
                            sparsity=s.copy(),
                            metric=metric,
                            knapsack_value=result.value,
                            knapsack_method=result.method,
                            resources_used=result.used,
                            resources_baseline=self._baseline,
                            structure_sparsity=rep["structure_sparsity"],
                            weight_sparsity=rep["weight_sparsity"],
                            seconds=time.time() - t0,
                            knapsack_seconds=t1 - t0,
                            finetune_seconds=t2 - t1,
                        )
                    )
                    ok = ((metric >= bound) if cfg.higher_is_better
                          else (metric <= bound))
                    logger.info(
                        "prune it=%d s=%s metric=%.4f (baseline %.4f) "
                        "structs=%.1f%% %s",
                        it, np.array2string(s, precision=2), metric,
                        baseline_metric, 100 * rep["structure_sparsity"],
                        "ok" if ok else "TOLERANCE BREAK",
                    )
            if not ok:
                params, masks = best  # roll back
                break
            best = (params, masks)
        return params, masks, logs
