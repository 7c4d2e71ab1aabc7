"""End-to-end run: train an LM, then resource-aware-prune it, with
fault-tolerant checkpointing throughout — torch port of
``examples/train_lm_pruned.py``.

    python -m repro_torch.paper.train_lm_pruned [--device cpu]          # ~10M params
    python -m repro_torch.paper.train_lm_pruned --full [--device cpu]   # ~100M params, 300 steps

Exercises the whole stack: the deterministic data pipeline, the Trainer
(preemption-safe, straggler monitor, async checkpoints), AdamW with fp32
state, then Algorithm 2 on the attention and MLP weights at 64x128
tiles: knapsack selection under the reference's TPU cost vectors and a
masked fine-tune per iteration.  ``--steps N`` overrides the training
steps, ``--ckpt-dir`` keeps the checkpoints (otherwise they go to a
temporary directory that is removed at the end).

Runs on the card unless ``--device cpu`` is given; without a card it
fails rather than fall back.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    BlockingSpec,
    IterativePruner,
    PruneConfig,
    TPUResourceModel,
    apply_masks,
    build_structures,
    constant_step,
)
from repro_torch.data import LMPipeline, TokenTask
from repro_torch.device import resolve_device
from repro_torch.models import cross_entropy_loss, init_params, lm_forward
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig, init_train_state, train_step_for

__all__ = ["run", "main"]


def run(*, full: bool = False, steps: Optional[int] = None,
        ckpt_dir: Optional[str] = None, device=None,
        log: Callable[[str], Any] = print) -> Dict[str, Any]:
    """Train and prune on ``device`` (default: the card); ``log`` gets the
    output lines.  Returns the trainer's result, the pruner's logs and
    the checkpoint directory."""
    dev = resolve_device(device)
    base = get_config("qwen1.5-0.5b")
    if full:
        cfg = base.replace(
            name="lm-100m", vocab=32768, d_model=640, n_layers=12, n_heads=10,
            kv_heads=10, head_dim=64, d_ff=2560, param_dtype="float32",
            activ_dtype="float32", remat="none", attn_chunk=256)
        steps = steps or 300
        batch, seq = 16, 512
    else:
        cfg = base.replace(
            name="lm-10m", vocab=2048, d_model=256, n_layers=4, n_heads=4,
            kv_heads=4, head_dim=64, d_ff=1024, param_dtype="float32",
            activ_dtype="float32", remat="none", attn_chunk=128)
        steps = steps or 60
        batch, seq = 8, 128

    log(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, {steps} steps")

    tmp = ckpt_dir is None
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="repro_lm_")
    try:
        params = init_params(cfg, seed=0, device=dev)
        opt_cfg = AdamWConfig(use_master=False)
        state = init_train_state(params, opt_cfg)
        step_fn = train_step_for(
            cfg, opt_cfg, warmup_cosine(3e-4, max(steps // 10, 1), steps), dev)
        task = TokenTask(vocab=cfg.vocab, noise=0.02)
        pipe = LMPipeline(task, batch, seq, device=dev)

        trainer = Trainer(
            step_fn, state, pipe.batch_at,
            TrainerConfig(total_steps=steps, ckpt_every=max(steps // 4, 10),
                          ckpt_dir=ckpt_dir, log_every=max(steps // 10, 1)),
        )
        result = trainer.run()
        m = result["metrics"]
        log(f"training: loss {m[0]['total_loss']:.3f} -> {m[-1]['total_loss']:.3f} "
            f"({result['final_step']} steps, ckpts in {ckpt_dir})")

        # ---- paper technique: prune the trained LM --------------------------
        params = trainer.state["params"]
        structures = build_structures(params, BlockingSpec(bk=64, bn=128),
                                      min_size=16_384)
        rm = TPUResourceModel(precision="bf16")
        pruner = IterativePruner(
            structures, rm,
            PruneConfig(schedule=constant_step([0.4, 0.4], 0.2), tolerance=0.10,
                        higher_is_better=False),
        )
        val = pipe.batch_at(1_000_000)
        fstep = train_step_for(cfg, opt_cfg, warmup_cosine(1e-4, 2, 30), dev,
                               what="fine-tune step")

        @torch.no_grad()
        def eval_fn(p, masks):
            logits, _ = lm_forward(apply_masks(p, masks), val, cfg)
            return float(cross_entropy_loss(logits, val["labels"]))

        def finetune_fn(p, masks):
            st = init_train_state(p, opt_cfg, masks=masks)
            for s in range(15):
                st, _ = fstep(st, pipe.batch_at(2_000_000 + s))
            return st["params"]

        params, masks, logs = pruner.run(params, finetune_fn, eval_fn)
        for it in logs:
            red = it.reduction()
            log(f"prune iter {it.iteration}: val loss={it.metric:.3f} "
                f"structures pruned={it.structure_sparsity:.1%} "
                f"MXU={red[0]:.2f}x HBM={red[1]:.2f}x")
        log("done.")
    finally:
        if tmp:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"result": result, "logs": logs, "ckpt_dir": ckpt_dir,
            "params": params, "masks": masks}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="~100M params / 300 steps (sized for the card)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)
    run(full=args.full, steps=args.steps, ckpt_dir=args.ckpt_dir,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
