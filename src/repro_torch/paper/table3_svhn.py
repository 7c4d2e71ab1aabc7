"""Paper Table III: SVHN CNN, DSP-aware pruning at RF in {3, 9, 27};
torch port of ``benchmarks/table3_svhn.py``.

Paper: DSP reductions 3.9x / 3.6x / 2.2x with accuracy *maintained* (the
pruned models even improve slightly).  Reproduced on the synthetic
32x32x3 digit-stand-in task with the same architecture.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core import BlockingSpec
from repro_torch.data import ImageTask
from repro_torch.models.cnn import init_svhn_cnn, svhn_cnn_forward

from .fpga_repro import FpgaResourceModel, run_experiments

__all__ = ["RFS", "experiments", "run", "lines", "main"]

RFS = [3, 9, 27]


def experiments(quick: bool = False, device=None) -> List[Tuple[Dict, Dict]]:
    """(row labels, ``prune_experiment`` arguments) of every row."""
    task = ImageTask(height=32, width=32, channels=3, classes=10, seed=5)
    val = task.batch(99_999, 1024)
    return [({"rf": rf}, dict(
        init_fn=init_svhn_cnn,
        forward=svhn_cnn_forward,
        batch_fn=lambda s: task.batch(s, 128),
        val_batch=val,
        blocking_per_layer={"default": BlockingSpec(bk=rf, bn=1)},
        models_per_layer=FpgaResourceModel(rf=rf, precision_bits=16),
        target=(0.8, 0.8),
        step_size=0.2,
        pretrain_steps=80 if quick else 150,
        finetune_steps=20 if quick else 40,
        min_size=128,
        device=device,
    )) for rf in (RFS if not quick else [3])]


def run(quick: bool = False, device=None) -> List[Dict]:
    return run_experiments(experiments(quick, device))


def lines(rows: List[Dict]) -> List[str]:
    return [
        f"table3_svhn_rf{r['rf']},"
        f"{r['seconds']*1e6/max(r['iterations'],1):.0f},"
        f"dsp_red={r['dsp_reduction']:.2f}x "
        f"acc={r['baseline_acc']:.3f}->{r['pruned_acc']:.3f} "
        f"sparsity={r['structure_sparsity']:.2f}"
        for r in rows
    ]


def main(quick: bool = False, device=None) -> List[str]:
    return lines(run(quick, device))
