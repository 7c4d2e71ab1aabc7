"""Paper flagship: jet classification pruning with FPGA resource units,
torch port of ``examples/prune_jets.py``.

    python -m repro_torch.paper.prune_jets [--rf 4] [--md] [--target 0.9] \\
        [--device cpu]

Reproduces the Table II flow end to end: DSP-aware (--rf N) or
multi-dimensional DSP+BRAM-aware (--md, 18-bit) structures, iterative
knapsack pruning to the accuracy tolerance, reporting reductions in the
paper's own units (DSP blocks / BRAM36 blocks).  Runs on the card
unless ``--device cpu`` is given; without a card it fails rather than
fall back.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.core import BlockingSpec
from repro_torch.data import JetsTask
from repro_torch.models.cnn import init_jets_mlp, jets_mlp_forward

from .fpga_repro import FpgaResourceModel, bram_c, run_prune_experiment

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rf", type=int, default=4)
    ap.add_argument("--md", action="store_true", help="BRAM-aware (18-bit)")
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)

    task = JetsTask()
    if args.md:
        bits = 18
        c = bram_c(bits)
        blocking = BlockingSpec(bk=args.rf * c, bn=1, consecutive=c)
        rm = FpgaResourceModel(rf=args.rf, precision_bits=bits, multi_dim=True)
        print(f"multi-dimensional pruning: RF={args.rf}, P={bits}b, C={c}")
    else:
        bits = 16
        blocking = BlockingSpec(bk=args.rf, bn=1)
        rm = FpgaResourceModel(rf=args.rf, precision_bits=bits)
        print(f"DSP-aware pruning: RF={args.rf}, P={bits}b")

    res = run_prune_experiment(
        init_fn=init_jets_mlp,
        forward=jets_mlp_forward,
        batch_fn=lambda s: task.batch(s, 256),
        val_batch=task.batch(99_999, 2048),
        blocking_per_layer={"default": blocking},
        models_per_layer=rm,
        target=(args.target, args.target),
        step_size=0.15,
        min_size=256,
        device=args.device,
    )
    print(f"baseline acc {res['baseline_acc']:.3f} -> pruned {res['pruned_acc']:.3f} "
          f"({res['iterations']} iterations)")
    print(f"DSP reduction:  {res['dsp_reduction']:.2f}x "
          f"(paper Table II, RF={args.rf}: 12.2x/11.9x/7.9x/5.8x for RF 2/4/8/16)")
    print(f"BRAM reduction: {res['bram_reduction']:.2f}x")
    print(f"structure sparsity: {res['structure_sparsity']:.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
