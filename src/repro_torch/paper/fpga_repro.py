"""Shared machinery for reproducing the paper's FPGA tables, torch port
of ``benchmarks/fpga_repro.py``.

The paper's DSP group = RF consecutive weights of the transposed-flattened
matrix = a (bk=RF, bn=1) block of our (in, out) kernels.  BRAM-aware
(multi-dimensional) structures = C consecutive DSP groups = (bk=RF*C, bn=1).
Resource vectors use the paper's own units via
``TPUResourceModel.fpga_dsp_bram`` (DSP blocks, BRAM36 blocks), so the
reported reductions are directly comparable with Tables II/III/V.

Training is masked AdamW (no master copy, no weight decay) on the
classifier's cross-entropy, step by step in eager PyTorch on the params'
device (the reference jits the step).  Batches come from the task as CPU
tensors and are moved to that device per step; the validation batch is
moved once.  ``prune_experiment`` returns the pruned state itself (the
§III-C packing needs it); ``run_prune_experiment`` returns the
reference's summary dict, key for key.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (
    BlockingSpec,
    IterativePruner,
    LayerStructures,
    PruneConfig,
    PruneIterationLog,
    TPUResourceModel,
    apply_masks,
    build_structures,
    constant_step,
    init_masks,
)
from repro_torch.core.masks import map_tree, tree_leaves
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

__all__ = ["FpgaResourceModel", "bram_c", "classifier_loss_and_grads",
           "train_classifier", "accuracy", "PruneRun", "prune_experiment",
           "summarize", "run_prune_experiment", "run_experiments"]

Batch = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FpgaResourceModel(TPUResourceModel):
    """Resource vectors in the paper's FPGA units for one layer."""

    rf: int = 1
    precision_bits: int = 16
    fpga_strategy: str = "resource"
    multi_dim: bool = False

    def structure_cost(self, blocking: BlockingSpec) -> np.ndarray:
        dsp, bram = TPUResourceModel.fpga_dsp_bram(
            self.precision_bits, self.rf, self.fpga_strategy
        )
        if self.multi_dim:
            # one structure = C consecutive DSP groups = C DSPs, 1 BRAM
            c = max(blocking.bk // self.rf, 1)
            return np.array([dsp * c, 1.0 if self.fpga_strategy == "resource" else 0.0])
        return np.array([dsp, bram])


def bram_c(precision_bits: int) -> int:
    """Paper Eq. 1 with the 36-bit BRAM word."""
    if 36 % precision_bits == 0:
        return 36 // precision_bits
    return int(np.ceil(2 * 36 / precision_bits))


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def classifier_loss_and_grads(params, masks, forward, x: torch.Tensor,
                              y: torch.Tensor, reg=None):
    """(loss, grads like params) of the tables' loss: the mean
    cross-entropy of ``forward(params * masks, x)`` against the int
    labels ``y``, plus ``reg(params)`` when given.  The reference's
    ``-mean(sum(log_softmax * one_hot))`` has one nonzero term per row,
    so ``F.cross_entropy`` takes the same value."""
    leaves: List[torch.Tensor] = []

    def fresh(t):
        leaf = t.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    with torch.enable_grad():
        live = map_tree(fresh, params)
        logits = forward(apply_masks(live, masks), x)
        loss = F.cross_entropy(logits.to(torch.float32), y.long())
        if reg is not None:
            loss = loss + reg(live)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), map_tree(lambda _: next(grads), live)


def train_classifier(params, masks, forward, batch_fn: Callable[[int], Batch],
                     steps: int, lr: float = 5e-3, reg=None, seed0: int = 0):
    """``steps`` masked AdamW steps on ``batch_fn(seed0 + s)``; returns
    the new params (the input tree is left as it was)."""
    opt_cfg = AdamWConfig(use_master=False, weight_decay=0.0)
    opt = init_opt_state(params, opt_cfg)
    dev = _device_of(params)
    for s in range(steps):
        x, y = batch_fn(seed0 + s)
        _, grads = classifier_loss_and_grads(params, masks, forward, x.to(dev),
                                             y.to(dev), reg)
        params, opt = adamw_update(params, grads, opt, opt_cfg, lr, masks=masks)
    return params


@torch.no_grad()
def accuracy(params, masks, forward, batch: Batch) -> float:
    x, y = batch
    dev = _device_of(params)
    logits = forward(apply_masks(params, masks), x.to(dev))
    return float((torch.argmax(logits, -1) == y.to(dev).long())
                 .to(torch.float32).mean())


@dataclasses.dataclass
class PruneRun:
    """What one Algorithm 2 experiment leaves: the fine-tuned params, the
    final masks, the iteration logs and the pruner with its structures."""

    params: Dict[str, Any]
    masks: Dict[str, Any]
    logs: List[PruneIterationLog]
    structures: LayerStructures
    pruner: IterativePruner
    forward: Callable
    val_batch: Batch
    baseline_acc: float
    pretrain_seconds: float
    seconds: float                  # Algorithm 2's loop


def prune_experiment(
    *,
    init_fn,
    forward,
    batch_fn,
    val_batch: Batch,
    blocking_per_layer: Mapping[str, BlockingSpec],
    models_per_layer,
    target=(0.75, 0.75),
    step_size: float = 0.25,
    pretrain_steps: int = 150,
    finetune_steps: int = 40,
    tolerance: float = 0.04,
    min_size: int = 64,
    seed: int = 0,
    device=None,
) -> PruneRun:
    """Full Algorithm-2 run on ``device`` (default: the card): seeded
    init, pretraining, then the pruner with a masked fine-tune per
    iteration."""
    dev = resolve_device(device)
    params = init_fn(generator=torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
    val = tuple(t.to(dev) for t in val_batch)
    structures = build_structures(params, blocking_per_layer, min_size=min_size)
    masks0 = init_masks(params, structures)
    t0 = time.time()
    params = train_classifier(params, masks0, forward, batch_fn, pretrain_steps)
    base_acc = accuracy(params, masks0, forward, val)
    pretrain_s = time.time() - t0

    pruner = IterativePruner(
        structures, models_per_layer,
        PruneConfig(schedule=constant_step(list(target), step_size),
                    tolerance=tolerance),
    )
    t0 = time.time()
    params, masks, logs = pruner.run(
        params,
        lambda p, m: train_classifier(p, m, forward, batch_fn, finetune_steps,
                                      lr=2e-3, seed0=10_000),
        lambda p, m: accuracy(p, m, forward, val),
    )
    return PruneRun(params=params, masks=masks, logs=logs,
                    structures=structures, pruner=pruner, forward=forward,
                    val_batch=val, baseline_acc=base_acc,
                    pretrain_seconds=pretrain_s, seconds=time.time() - t0)


def summarize(run: PruneRun) -> Dict:
    """The reference's result dict: paper-style reductions and accuracies."""
    final = run.logs[-1] if run.logs else None
    red = final.reduction() if final else np.array([1.0, 1.0])
    return {
        "baseline_acc": run.baseline_acc,
        "pruned_acc": accuracy(run.params, run.masks, run.forward, run.val_batch),
        "dsp_reduction": float(red[0]),
        "bram_reduction": float(red[1]) if np.isfinite(red[1]) else float("inf"),
        "structure_sparsity": final.structure_sparsity if final else 0.0,
        "iterations": len(run.logs),
        "seconds": run.seconds,
        "baseline_resources": run.pruner.baseline_resources.tolist(),
    }


def run_prune_experiment(**kwargs) -> Dict:
    """Full Algorithm-2 run (``prune_experiment``'s arguments); returns
    paper-style reductions + accuracies."""
    return summarize(prune_experiment(**kwargs))


def run_experiments(experiments: List[Tuple[Dict, Dict]]) -> List[Dict]:
    """One summary row per (row labels, ``prune_experiment`` arguments),
    the labels merged into it."""
    rows = []
    for labels, kwargs in experiments:
        res = run_prune_experiment(**kwargs)
        res.update(labels)
        rows.append(res)
    return rows
