"""Paper Table II: jet classification, RF sweep, DSP- and BRAM-aware
pruning; torch port of ``benchmarks/table2_jets.py``.

Paper numbers (16-bit, Resource strategy): DSP reductions 12.2x / 11.9x /
7.9x / 5.8x for RF = 2/4/8/16 (BP-DSP), BRAM 3.9x/3.5x/2.7x/2.3x; BP-MD
trades DSP for BRAM.  The rows reproduce the *trend and magnitude* on
the synthetic jets task: larger structures = coarser pruning = an
earlier accuracy cliff.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core import BlockingSpec
from repro_torch.data import JetsTask
from repro_torch.models.cnn import init_jets_mlp, jets_mlp_forward

from .fpga_repro import FpgaResourceModel, bram_c, run_experiments

__all__ = ["RFS", "experiments", "run", "lines", "main"]

RFS = [2, 4, 8, 16]


def experiments(quick: bool = False, device=None) -> List[Tuple[Dict, Dict]]:
    """(row labels, ``prune_experiment`` arguments) of every row."""
    task = JetsTask()
    val = task.batch(99_999, 2048)
    out = []
    rfs = RFS if not quick else [2, 8]
    for rf in rfs:
        # md (BRAM-aware) mode at RF=2/8 keeps the paper's BP-MD comparison
        # without doubling every row, as the reference does
        for mode in ((["dsp", "md"] if rf in (2, 8) else ["dsp"])
                     if not quick else ["dsp"]):
            if mode == "dsp":
                bits = 16
                blocking = BlockingSpec(bk=rf, bn=1)
                rm = FpgaResourceModel(rf=rf, precision_bits=bits)
            else:
                bits = 18  # paper: BP-MD synthesized at 18-bit
                c = bram_c(bits)
                blocking = BlockingSpec(bk=rf * c, bn=1, consecutive=c)
                rm = FpgaResourceModel(rf=rf, precision_bits=bits, multi_dim=True)
            out.append(({"rf": rf, "mode": mode, "bits": bits}, dict(
                init_fn=init_jets_mlp,
                forward=jets_mlp_forward,
                batch_fn=lambda s: task.batch(s, 256),
                val_batch=val,
                blocking_per_layer={"default": blocking},
                models_per_layer=rm,
                target=(0.9, 0.9),
                step_size=0.15,
                pretrain_steps=120 if quick else 180,
                finetune_steps=30 if quick else 50,
                min_size=256,
                device=device,
            )))
    return out


def run(quick: bool = False, device=None) -> List[Dict]:
    return run_experiments(experiments(quick, device))


def lines(rows: List[Dict]) -> List[str]:
    return [
        f"table2_jets_rf{r['rf']}_{r['mode']},"
        f"{r['seconds']*1e6/max(r['iterations'],1):.0f},"
        f"dsp_red={r['dsp_reduction']:.2f}x bram_red={r['bram_reduction']:.2f}x "
        f"acc={r['baseline_acc']:.3f}->{r['pruned_acc']:.3f} "
        f"sparsity={r['structure_sparsity']:.2f}"
        for r in rows
    ]


def main(quick: bool = False, device=None) -> List[str]:
    return lines(run(quick, device))
