"""Quickstart: resource-aware structured pruning in about a minute,
torch port of ``examples/quickstart.py``.

    python -m repro_torch.paper.quickstart [--device cpu]

1. trains the jets MLP on the synthetic jets task,
2. partitions its weights into 8x8 tile structures (the paper's
   DSP-group analogue, §III-A),
3. solves the multi-dimensional knapsack (§III-B) to keep the most
   valuable structures under a 50% compute + 50% memory budget
   (``TPUResourceModel("bf16")``, the reference's cost vectors),
4. fine-tunes, packs ``fc_1``'s survivors to block-sparse (BSR) and runs
   them through ``ops.bsr_matmul`` — the Hopper kernel on the card —
   comparing with the masked dense product.

Runs on the card unless ``--device cpu`` is given; without a card it
fails rather than fall back.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.core import (
    BlockingSpec,
    IterativePruner,
    PruneConfig,
    TPUResourceModel,
    apply_masks,
    build_structures,
    constant_step,
    init_masks,
    pack_bsr,
)
from repro_torch.data import JetsTask
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.cnn import init_jets_mlp, jets_mlp_forward

from .fpga_repro import accuracy, train_classifier

__all__ = ["run", "main"]


def run(device=None, log: Callable[[str], Any] = print) -> Dict[str, Any]:
    """The quickstart flow on ``device`` (default: the card); ``log``
    gets the reference's output lines.  Returns the BSR product, the
    masked dense one and the pruner's logs."""
    dev = resolve_device(device)
    task = JetsTask()
    params = init_jets_mlp(generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)

    def train(p, m, steps):
        return train_classifier(p, m, jets_mlp_forward,
                                lambda s: task.batch(s, 256), steps)

    # -- 1. resource-aware structures ------------------------------------
    blocking = BlockingSpec(bk=8, bn=8)        # the "RF" analogue
    structures = build_structures(params, blocking, min_size=256)
    rm = TPUResourceModel(precision="bf16")
    log(f"structures: {structures.total_structures} "
        f"(cost per structure = {rm.structure_cost(blocking)})")

    # -- 2. baseline training ----------------------------------------------
    masks = init_masks(params, structures)
    params = train(params, masks, 150)
    val = tuple(t.to(dev) for t in task.batch(9_999, 2048))
    log(f"baseline accuracy: "
        f"{accuracy(params, masks, jets_mlp_forward, val):.3f}")

    # -- 3. iterative knapsack pruning (Algorithm 2) -------------------------
    pruner = IterativePruner(
        structures, rm,
        PruneConfig(schedule=constant_step([0.5, 0.5], 0.25), tolerance=0.03),
    )
    params, masks, logs = pruner.run(
        params,
        lambda p, m: train(p, m, 40),
        lambda p, m: accuracy(p, m, jets_mlp_forward, val),
    )
    for it in logs:
        red = it.reduction()
        log(f"  iter {it.iteration}: acc={it.metric:.3f} "
            f"structure sparsity={it.structure_sparsity:.1%} "
            f"MXU reduction={red[0]:.2f}x HBM reduction={red[1]:.2f}x")

    # -- 4. zero-skipping serving path ------------------------------------
    x = task.batch(7, 32)[0].to(dev)
    mp = apply_masks(params, masks)
    bsr = pack_bsr(params["fc_1"]["kernel"], blocking,
                   mask=masks["fc_1"]["kernel"])
    with torch.no_grad():
        y_sparse = ops.bsr_matmul(x, bsr)
        y_dense = x @ mp["fc_1"]["kernel"]
    err = float((y_sparse - y_dense).abs().max())
    log(f"BSR serving: density={bsr.density():.2f}, "
        f"max|sparse-dense|={err:.2e}")
    log("done.")
    return {"y_sparse": y_sparse, "y_dense": y_dense, "max_abs_err": err,
            "density": bsr.density(), "logs": logs, "bsr": bsr}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
