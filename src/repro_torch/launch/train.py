"""Training launcher of the torch port:

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 200 \\
        --batch 8 --seq 128 [--prune] [--smoke] [--device cpu]

Counterpart of ``src/repro/launch/train.py``, flag for flag.  It trains
the model from seeded random weights on ``TokenTask`` data with masked
AdamW under a warmup-cosine schedule, through the fault-tolerant
``Trainer`` (checkpoints in ``--ckpt-dir``, resumed from when present).
``--prune`` then runs the paper's Algorithm 2 (``IterativePruner``):
structure scores, the knapsack over the reference's TPU cost vectors at
128x128 tiles, masks, a 10-step masked fine-tune per iteration and an
evaluation, rolling back past the tolerance.  It prunes the weights the
reference's launcher prunes (``prune_structures``: every matmul weight
of at least 4096 elements, the embedding and the router included).  The
survivors are then packed (``pack_pruned``: the attention, MLP and
expert weights as BSR, the masked embedding and router dense) and the
packed forward is held against the masked dense one.

The run is on the card unless ``--device cpu`` is given; without a card
it fails rather than fall back.  On the card the train step and the
fine-tune's step run as CUDA graph replays (``train.GraphedTrainStep``
over ``make_train_body``, the reference's ``jax.jit`` of its step); on
the CPU, and under a mesh, they run eagerly (``make_train_step``).
``--mesh single|multi`` builds the production mesh (``launch/mesh.py``)
over the process group, which raises its ``RuntimeError`` on a world
smaller than 256 or 512 ranks, as the reference's launcher does on
fewer devices, and trains over it:
``LMPipeline(mesh=)`` shards each batch over "data", and the state is
replicated, since the launcher installs no rules, as the reference's
does: pure data parallelism, the gradients all-reduced.
``build_trainer(..., mesh=)`` takes any mesh (the tests pass a small
one over CPU ranks).
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import Any, Dict, Optional, Sequence

import torch

__all__ = ["build_trainer", "prune_structures", "prune", "pack_pruned",
           "packed_forward_error", "main"]

# Algorithm 2's settings, as the reference's launcher hard-codes them.
PRUNE_BLOCK = (128, 128)
PRUNE_MIN_SIZE = 4096
FINETUNE_STEPS = 10


def build_trainer(cfg, *, steps: int, batch: int, seq: int, lr: float,
                  seed: int, device, ckpt_dir: str, ckpt_every: int,
                  log_every: Optional[int] = None, mesh=None, opt=None):
    """(trainer, pipeline, AdamW config) of the launcher's training run:
    seeded params on ``device``, AdamW by ``opt`` (default: fp32 master
    weights unless the params are fp32),
    ``warmup_cosine(lr, steps // 10 + 1, steps)``.  The step is
    ``train.train_step_for``'s: graphed on the card.  With ``mesh`` (a
    ``DeviceMesh``; ``device`` is then the rank's) the state is
    replicated over it, the batches sharded over "data", and every step
    runs eagerly under the mesh."""
    from repro_torch.core.masks import map_tree
    from repro_torch.data import LMPipeline, TokenTask
    from repro_torch.distributed import distribute_tree, use_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig, init_train_state, train_step_for

    params = init_params(cfg, seed=seed, device=device)
    opt_cfg = opt or AdamWConfig(use_master=cfg.param_dtype != "float32")
    state = init_train_state(params, opt_cfg)
    step = train_step_for(cfg, opt_cfg, warmup_cosine(lr, steps // 10 + 1, steps),
                          device, mesh=mesh)
    pipe = LMPipeline(TokenTask(vocab=cfg.vocab, seed=seed), batch, seq,
                      device=device, mesh=mesh)
    if mesh is not None:
        state = distribute_tree(state, map_tree(lambda _: (), state), mesh)
        replicated_step = step

        def step(state, batch):
            with use_mesh(mesh):
                return replicated_step(state, batch)
    trainer = Trainer(
        step, state, pipe.batch_at,
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                      log_every=log_every or max(steps // 20, 1)))
    return trainer, pipe, opt_cfg


def prune_structures(params):
    """The structures Algorithm 2 prunes, as the reference's launcher
    builds them (``src/repro/launch/train.py:79-80``): ``PRUNE_BLOCK``
    tiles of every matmul weight of at least ``PRUNE_MIN_SIZE`` elements
    under ``build_structures``' default exclusions, so the embedding and
    the router are pruned too."""
    from repro_torch.core import BlockingSpec, build_structures
    return build_structures(params, BlockingSpec(*PRUNE_BLOCK),
                            min_size=PRUNE_MIN_SIZE)


def pack_pruned(params, masks):
    """The pruned params with what ``pack_params`` can pack packed: the
    attention, MLP and expert weights (``DEFAULT_INCLUDE`` /
    ``DEFAULT_EXCLUDE``) as BSR at ``PRUNE_BLOCK`` tiles, every other
    leaf masked and dense (the embedding, which ``lm_forward`` looks up,
    and the router)."""
    from repro_torch.core import BlockingSpec, apply_masks, build_structures
    from repro_torch.sparse import DEFAULT_EXCLUDE, DEFAULT_INCLUDE, pack_params
    packable = build_structures(params, BlockingSpec(*PRUNE_BLOCK),
                                include=DEFAULT_INCLUDE, exclude=DEFAULT_EXCLUDE,
                                min_size=PRUNE_MIN_SIZE)
    return pack_params(apply_masks(params, masks), masks, packable)


def prune(params, cfg, pipe, opt_cfg, *, lr: float, target: float):
    """Algorithm 2 over ``prune_structures(params)``, as the reference's
    launcher drives it: ``constant_step([target] * 2, 0.1)``, tolerance
    0.05 on the eval loss (lower is better), each iteration fine-tuned
    for ``FINETUNE_STEPS`` steps with ``warmup_cosine(lr / 3, 2, 20)`` on
    fresh optimizer state.  On the card one graphed step
    (``train.train_step_for``) serves every fine-tune: each copies its
    fresh state and masks in.  Returns (params, masks, logs, structures,
    pruner)."""
    from repro_torch.core import (
        IterativePruner, PruneConfig, TPUResourceModel, apply_masks, constant_step,
    )
    from repro_torch.core.masks import tree_leaves
    from repro_torch.models import cross_entropy_loss, lm_forward
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import init_train_state, train_step_for

    structures = prune_structures(params)
    pruner = IterativePruner(
        structures,
        TPUResourceModel(precision=("bf16" if cfg.param_dtype == "bfloat16"
                                    else "fp32")),
        PruneConfig(schedule=constant_step([target, target], 0.1),
                    tolerance=0.05, higher_is_better=False),
    )
    eval_batch = pipe.batch_at(10_000)
    fstep = train_step_for(cfg, opt_cfg, warmup_cosine(lr / 3, 2, 20),
                           tree_leaves(params)[0].device, what="fine-tune step")

    @torch.no_grad()
    def eval_fn(p, masks):
        logits, _ = lm_forward(apply_masks(p, masks), eval_batch, cfg)
        return float(cross_entropy_loss(logits, eval_batch["labels"]))

    def finetune_fn(p, masks):
        st = init_train_state(p, opt_cfg, masks=masks)
        for s in range(FINETUNE_STEPS):
            st, _ = fstep(st, pipe.batch_at(20_000 + s))
        return st["params"]

    params, masks, logs = pruner.run(params, finetune_fn, eval_fn)
    return params, masks, logs, structures, pruner


@torch.no_grad()
def packed_forward_error(packed, params, masks, batch, cfg) -> Dict[str, Any]:
    """``lm_forward`` on the packed params (``pack_pruned``) against
    ``lm_forward`` on the masked dense params: the largest |difference|
    of the logits and the largest |logit|."""
    from repro_torch.core import apply_masks
    from repro_torch.models import lm_forward
    got, _ = lm_forward(packed, batch, cfg)
    want, _ = lm_forward(apply_masks(params, masks), batch, cfg)
    return {"max_abs_diff": float((got - want).abs().max()),
            "max_abs_logit": float(want.abs().max()),
            "finite": bool(torch.isfinite(got).all())}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--prune", action="store_true",
                    help="run resource-aware pruning after training")
    ap.add_argument("--prune-target", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    from repro_torch.configs import get_config, make_smoke
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import make_production_mesh

        # raises on a world smaller than the mesh, as the reference does
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=device.type)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = make_smoke(cfg)

    trainer, pipe, opt_cfg = build_trainer(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        seed=args.seed, device=device, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, mesh=mesh)
    result = trainer.run()
    print(f"done: step={result['final_step']} preempted={result['preempted']} "
          f"stragglers={len(result['stragglers'])}")
    if result["metrics"]:
        first, last = result["metrics"][0], result["metrics"][-1]
        print(f"loss {first['total_loss']:.4f} -> {last['total_loss']:.4f}")

    if args.prune:
        from repro_torch.sparse import sparsity_summary

        params, masks, logs, _, _ = prune(
            trainer.state["params"], cfg, pipe, opt_cfg, lr=args.lr,
            target=args.prune_target)
        for log in logs:
            red = log.reduction()
            print(f"prune it={log.iteration} metric={log.metric:.4f} "
                  f"structs={log.structure_sparsity:.1%} "
                  f"mxu_red={red[0]:.2f}x hbm_red={red[1]:.2f}x")
        packed = pack_pruned(params, masks)
        summ = sparsity_summary(packed)
        err = packed_forward_error(packed, params, masks, pipe.batch_at(10_000), cfg)
        print(f"packed: {summ['nnz_blocks']}/{summ['total_blocks']} tiles live "
              f"(density {summ['density']:.4f}); packed vs masked dense logits "
              f"max |diff| {err['max_abs_diff']:.3g} of max |logit| "
              f"{err['max_abs_logit']:.3g}")
        if not err["finite"]:
            print("packed forward produced non-finite logits", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
