"""Serving with pruned weights through the zero-skipping BSR path, torch
port of ``examples/serve_pruned.py``.

    python -m repro_torch.paper.serve_pruned [--device cpu]

Trains a small LM briefly, knapsack-prunes its MLP weights at 128x128
tiles, packs the survivors with ``repro_torch.sparse.pack_params`` and
decodes a batch greedily straight on the packed params: every matmul
routes through ``models/layers.matmul``, so a packed weight goes through
``ops.bsr_matmul`` — the Hopper kernel on the card — and pruned tiles are
*skipped*.  The packed-vs-masked-dense equivalence is spot-checked with
``unpack_params``, the same oracle the tests use: the packed tree
reconstructs to the masked dense one within 1e-6, and one decode step
agrees between the two within atol 1e-3, rtol 1e-4.

Runs on the card unless ``--device cpu`` is given; without a card it
fails rather than fall back.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import BlockingSpec, apply_masks
from repro_torch.core.masks import _get_path
from repro_torch.data import TokenTask
from repro_torch.device import resolve_device
from repro_torch.models import init_caches, init_params, lm_decode, lm_generate, lm_prefill
from repro_torch.optim import AdamWConfig, constant_lr
from repro_torch.sparse import knapsack_prune, pack_params, sparsity_summary, unpack_params
from repro_torch.train import init_train_state, train_step_for

__all__ = ["run", "main"]


def run(device=None, log: Callable[[str], Any] = print) -> Dict[str, Any]:
    """The example on ``device`` (default: the card); ``log`` gets its
    output lines.  Returns the decoded tokens, the selection's kept and
    total structures and the two checks' largest differences."""
    dev = resolve_device(device)
    cfg = get_config("qwen1.5-0.5b").replace(
        name="serve-demo", vocab=512, d_model=256, n_layers=2, n_heads=4,
        kv_heads=4, head_dim=64, d_ff=512, param_dtype="float32",
        activ_dtype="float32", remat="none", attn_chunk=64)
    params = init_params(cfg, seed=0, device=dev)

    # brief training so magnitudes are meaningful
    opt_cfg = AdamWConfig(use_master=False)
    state = init_train_state(params, opt_cfg)
    step = train_step_for(cfg, opt_cfg, constant_lr(1e-3), dev)
    task = TokenTask(vocab=cfg.vocab, noise=0.02)
    for s in range(30):
        batch = {k: v.to(dev) for k, v in task.batch(s, 8, 64).items()}
        state, metrics = step(state, batch)
    params = state["params"]
    log(f"trained: loss={float(metrics['total_loss']):.3f}")

    # knapsack-prune the MLP weights at tile granularity, pack to BSR
    sel = knapsack_prune(
        params, sparsity=0.5, blocking=BlockingSpec(bk=128, bn=128),
        include=("mlp",), min_size=4096)
    log(f"knapsack kept {sel.kept}/{sel.total} structures "
        f"({sel.result.method}, feasible={sel.result.feasible}; "
        f"budget 50% MXU + 50% HBM)")
    packed = pack_params(params, sel.masks, sel.structures)
    summ = sparsity_summary(packed)
    for path, d in sorted(summ["per_path"].items()):
        log(f"  {path}: BSR density {d:.2f} "
            f"(skips {1 - d:.0%} of the tiles' compute and bytes)")

    # serve: one batched prefill fills the caches, then greedy decode with
    # the argmax on the device — one host transfer at the end
    b, plen, steps = 4, 8, 16
    with torch.no_grad():
        caches = init_caches(cfg, b, plen + steps, torch.float32, dev)
        gen = torch.Generator(device="cpu").manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (b, plen), generator=gen).to(dev)
        logits, caches = lm_prefill(packed, caches, {"tokens": prompt}, cfg)
        first = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        tokens, caches = lm_generate(packed, caches, first, plen, steps, cfg)
        tokens = tokens.cpu().numpy()          # the single host transfer

        # spot-check: the packed tree reconstructs to exactly masked dense,
        # and one decode step agrees between the two executions
        masked = apply_masks(params, sel.masks)
        recon = unpack_params(packed)
        path = sel.structures.infos[0].path
        got, want = _get_path(recon, path), _get_path(masked, path)
        recon_err = float((got - want).abs().max())
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-6)

        caches_d = init_caches(cfg, b, 2, torch.float32, dev)
        caches_p = init_caches(cfg, b, 2, torch.float32, dev)
        tok0 = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        ld, _ = lm_decode(masked, caches_d, {"tokens": tok0}, 0, cfg)
        lp, _ = lm_decode(packed, caches_p, {"tokens": tok0}, 0, cfg)
        step_err = float((lp - ld).abs().max())
        np.testing.assert_allclose(lp.cpu().numpy(), ld.cpu().numpy(),
                                   atol=1e-3, rtol=1e-4)
    log(f"decoded {steps} tokens x {b} seqs; BSR path == masked dense. done.")
    return {"tokens": tokens, "kept": sel.kept, "total": sel.total,
            "recon_max_abs_err": recon_err, "decode_max_abs_err": step_err,
            "density": summ["density"]}


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
