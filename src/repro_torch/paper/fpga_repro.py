"""Shared machinery for reproducing the paper's FPGA tables, torch port
of ``benchmarks/fpga_repro.py``.

The paper's DSP group = RF consecutive weights of the transposed-flattened
matrix = a (bk=RF, bn=1) block of our (in, out) kernels.  BRAM-aware
(multi-dimensional) structures = C consecutive DSP groups = (bk=RF*C, bn=1).
Resource vectors use the paper's own units via
``TPUResourceModel.fpga_dsp_bram`` (DSP blocks, BRAM36 blocks), so the
reported reductions are directly comparable with Tables II/III/V.

Training is masked AdamW (no master copy, no weight decay) on the
classifier's cross-entropy.  On the card ``train_classifier`` captures
its step (``classifier_step_``, in place on a static params / optimizer
state / batch) as one CUDA graph per call and replays it, as the
reference's ``jax.jit`` inside the function traces once per call; each
batch goes through a pinned staging buffer with an asynchronous copy
into the static input (the host fills it again once that copy ended, so
it runs up to one replay ahead).  On the CPU, or with ``cuda_graphs=False``, the
step runs eagerly and each batch is moved to the params' device.  The
validation batch is moved once; ``accuracy`` runs eagerly, as the
reference's does.  ``prune_experiment`` returns the pruned state itself
(the §III-C packing needs it); ``run_prune_experiment`` returns the
reference's summary dict, key for key.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

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
from repro_torch.optim import AdamWConfig, adamw_update, adamw_update_, init_opt_state
from repro_torch.serving.graphs import GraphFailure, _sync_debug_error, capture

__all__ = ["FpgaResourceModel", "bram_c", "classifier_loss_and_grads",
           "classifier_step_", "train_classifier", "accuracy", "PruneRun",
           "prune_experiment", "summarize", "run_prune_experiment",
           "run_experiments"]

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


def classifier_step_(params, opt, masks, forward, x: torch.Tensor,
                     y: torch.Tensor, opt_cfg: AdamWConfig, lr, reg=None
                     ) -> torch.Tensor:
    """One masked AdamW step of ``train_classifier`` in place: the new
    params and optimizer state are written into ``params`` and ``opt``.
    Returns the loss before the step (a device scalar).  The step a CUDA
    graph captures; its numbers are the eager step's, bit for bit."""
    loss, grads = classifier_loss_and_grads(params, masks, forward, x, y, reg)
    adamw_update_(params, grads, opt, opt_cfg, lr, masks=masks)
    return loss


def train_classifier(params, masks, forward, batch_fn: Callable[[int], Batch],
                     steps: int, lr: float = 5e-3, reg=None, seed0: int = 0, *,
                     cuda_graphs: bool = True,
                     graph_log: Optional[List[Dict[str, Any]]] = None):
    """``steps`` masked AdamW steps on ``batch_fn(seed0 + s)``; returns
    the new params (the input tree is left as it was).  On the card,
    unless ``cuda_graphs`` is False, the steps replay one CUDA graph
    captured in this call (``_graphed_steps``; a failure raises
    ``GraphFailure``), and ``graph_log``, if given, gets the call's
    capture record appended."""
    opt_cfg = AdamWConfig(use_master=False, weight_decay=0.0)
    dev = _device_of(params)
    if dev.type == "cuda" and cuda_graphs and steps > 0:
        return _graphed_steps(params, masks, forward, batch_fn, steps, lr, reg,
                              seed0, opt_cfg, graph_log)
    opt = init_opt_state(params, opt_cfg)
    for s in range(steps):
        x, y = batch_fn(seed0 + s)
        _, grads = classifier_loss_and_grads(params, masks, forward, x.to(dev),
                                             y.to(dev), reg)
        params, opt = adamw_update(params, grads, opt, opt_cfg, lr, masks=masks)
    return params


class _Staging:
    """A batch's way to the card: a pinned host buffer per input, copied
    asynchronously into the static device input; the buffer is written
    again only after its last copy ended."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, dev: torch.device):
        self.static = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in (x, y)]
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in (x, y)]
        self.copied = None

    def ready(self) -> None:
        """Wait until the buffer's last copy to the card has ended."""
        if self.copied is not None:
            self.copied.synchronize()

    def put(self, x: torch.Tensor, y: torch.Tensor) -> None:
        """Stage ``(x, y)`` (host tensors, after ``ready``) and enqueue
        their copies into the static inputs on the current stream."""
        for t, s in zip((x, y), self.static):
            if t.shape != s.shape or t.dtype != s.dtype:
                raise GraphFailure(f"classifier step captured over {tuple(s.shape)} "
                                   f"{s.dtype}, called with {tuple(t.shape)} {t.dtype}")
        for t, h, s in zip((x, y), self.host, self.static):
            h.copy_(t)
            s.copy_(h, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()


def _graphed_steps(params, masks, forward, batch_fn, steps, lr, reg, seed0,
                   opt_cfg, graph_log):
    """``train_classifier`` on the card: the loop owns a static copy of
    the params and fresh optimizer state; the first step is the
    capture's warm-up run, the others replay the graph, each with its
    batch copy under sync-debug "error"; the params are cloned out once,
    at the end."""
    dev = _device_of(params)
    t0 = time.perf_counter()
    try:
        p = map_tree(torch.clone, params)
        opt = init_opt_state(p, opt_cfg)
        x, y = batch_fn(seed0)
        stage = _Staging(x, y, dev)
        stage.put(x, y)
    except RuntimeError as err:
        raise GraphFailure(f"capture of the classifier step failed: {err}") from err
    sx, sy = stage.static
    _, graph = capture(lambda: classifier_step_(p, opt, masks, forward, sx, sy,
                                                opt_cfg, lr, reg),
                       dev, torch.cuda.graph_pool_handle(), "classifier step")
    for s in range(1, steps):
        x, y = batch_fn(seed0 + s)
        stage.ready()
        try:
            with _sync_debug_error():
                stage.put(x, y)
                graph.replay()
        except RuntimeError as err:
            raise GraphFailure(f"replay of the classifier step failed: {err}") from err
    out = map_tree(torch.clone, p)
    if graph_log is not None:
        graph_log.append(dict(steps=steps, capture_seconds=graph.capture_seconds,
                              split=dict(graph.split), replays=graph.replays,
                              seconds=time.perf_counter() - t0))
    return out


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
    graph_log: Optional[List[Dict[str, Any]]] = None,
) -> PruneRun:
    """Full Algorithm-2 run on ``device`` (default: the card): seeded
    init, pretraining, then the pruner with a masked fine-tune per
    iteration.  ``graph_log`` collects the capture record of each
    ``train_classifier`` call on the card."""
    dev = resolve_device(device)
    params = init_fn(generator=torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
    val = tuple(t.to(dev) for t in val_batch)
    structures = build_structures(params, blocking_per_layer, min_size=min_size)
    masks0 = init_masks(params, structures)
    t0 = time.time()
    params = train_classifier(params, masks0, forward, batch_fn, pretrain_steps,
                              graph_log=graph_log)
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
                                      lr=2e-3, seed0=10_000, graph_log=graph_log),
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
