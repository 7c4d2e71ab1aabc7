"""Paper Table V: heterogeneous multi-dimensional pruning of LeNet;
torch port of ``benchmarks/table5_lenet.py``.

The showcase of the knapsack formulation (paper §IV-D): CONV layers in
Latency strategy have per-weight resource vector [1 DSP, 0 BRAM];
FC layers in Resource strategy at 18 bits have per-*structure* vectors
[2 DSP, 1 BRAM].  One *global* MDKP trades them off.  Paper: 4.7x DSP,
1.2-2.1x BRAM at unchanged accuracy.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core import BlockingSpec
from repro_torch.data import ImageTask
from repro_torch.models.cnn import LENET_LAYER_CFG, init_lenet, lenet_forward

from .fpga_repro import FpgaResourceModel, bram_c, run_experiments

__all__ = ["layer_config", "experiments", "run", "lines", "main"]


def layer_config() -> Tuple[Dict[str, BlockingSpec], Dict[str, FpgaResourceModel]]:
    """Per-layer blockings and resource models from ``LENET_LAYER_CFG``."""
    blocking: Dict[str, BlockingSpec] = {}
    models: Dict[str, FpgaResourceModel] = {}
    for layer in LENET_LAYER_CFG:
        path_k = f"{layer.name}/kernel"
        if layer.strategy == "latency":
            # unstructured-ish: tiny structures, [1, 0] per weight group
            blocking[path_k] = BlockingSpec(bk=1, bn=1)
            models[path_k] = FpgaResourceModel(
                rf=1, precision_bits=layer.precision_bits, fpga_strategy="latency")
        else:
            c = bram_c(layer.precision_bits)           # 18 bits -> C = 2
            blocking[path_k] = BlockingSpec(bk=layer.rf * c, bn=1, consecutive=c)
            models[path_k] = FpgaResourceModel(
                rf=layer.rf, precision_bits=layer.precision_bits, multi_dim=True)
    blocking["default"] = BlockingSpec(bk=1, bn=1)
    models["default"] = FpgaResourceModel(rf=1, precision_bits=18,
                                          fpga_strategy="latency")
    return blocking, models


def experiments(quick: bool = False, device=None) -> List[Tuple[Dict, Dict]]:
    """(row labels, ``prune_experiment`` arguments) of the one row."""
    task = ImageTask(height=28, width=28, channels=1, classes=10, seed=11)
    blocking, models = layer_config()
    return [({}, dict(
        init_fn=init_lenet,
        forward=lenet_forward,
        batch_fn=lambda s: task.batch(s, 128),
        val_batch=task.batch(99_999, 1024),
        blocking_per_layer=blocking,
        models_per_layer=models,
        target=(0.85, 0.85),
        step_size=0.2,
        pretrain_steps=80 if quick else 150,
        finetune_steps=20 if quick else 40,
        min_size=50,
        device=device,
    ))]


def run(quick: bool = False, device=None) -> List[Dict]:
    return run_experiments(experiments(quick, device))


def lines(rows: List[Dict]) -> List[str]:
    return [
        f"table5_lenet_md,"
        f"{r['seconds']*1e6/max(r['iterations'],1):.0f},"
        f"dsp_red={r['dsp_reduction']:.2f}x bram_red={r['bram_reduction']:.2f}x "
        f"acc={r['baseline_acc']:.3f}->{r['pruned_acc']:.3f}"
        for r in rows
    ]


def main(quick: bool = False, device=None) -> List[str]:
    return lines(run(quick, device))
