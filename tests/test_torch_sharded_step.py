"""The sharded program on 4 gloo ranks against the reference's unsharded
step.

One spawn of 4 CPU ranks (``run_ranks``) runs, on a (2, 2) ("data",
"model") mesh under the train rules, with the state placed by
``launch.specs`` (Megatron tensor parallelism on "model", FSDP on
"data"):

* qwen1.5-0.5b smoke and granite-moe-1b-a400m smoke (through
  ``moe_apply``), and granite once more under ``remat="dots"`` on both
  sides (the selective checkpoint over DTensor products and the
  per-shard router): two fp32 train steps from bridged params; the
  losses and the gathered params match the reference's jitted
  ``train_step`` on one device within 1e-5 relative.  AdamW runs in its linear regime
  (eps 1, no weight decay, lr 1), so an update carries its gradient's
  precision: at eps 1e-8 Adam turns the fp32 rounding of a near-zero
  gradient into a step of +-lr in either package (the port's own
  unsharded step is 2e-2 from the reference's on qwen's k bias there);
* two decode steps (the decode rules, caches placed by
  ``cache_pspecs``): the gathered logits match the reference's
  ``lm_decode`` within 1e-5 of the largest logit;
* ``LMPipeline(mesh=)`` batches, gathered, equal the host batches;
* a train state saved from the (2, 2) mesh restores on a (4, 1) mesh of
  the same ranks to the same tensors, and a state that mixes DTensors
  with plain tensors is refused;
* ``build_trainer(mesh=)`` (state replicated, batches sharded: the
  launcher's data parallelism) stopped at step 2 and resumed to 4 ends
  equal to an uninterrupted run to 4, and that run's losses and each
  param's change match ``build_trainer(mesh=None)`` on the whole batch
  within 1e-5 relative.  AdamW runs in its linear regime there too, and
  unclipped, so a gradient summed rather than averaged over the data
  ranks, or one from half the batch, would show (at lr 1, as above, a
  change is large beside the rounding of the params it is taken from).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.models.transformer import init_caches as jinit_caches
from repro.models.transformer import init_params as jinit_params
from repro.models.transformer import lm_decode as jlm_decode
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.bridge import params_from_reference
from repro_torch.distributed import run_ranks

ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m")
TRAIN_CASES = ARCHS + ("granite-moe-1b-a400m/dots",)    # arch[/remat]
B, S, STEPS, LR = 4, 16, 2, 1.0
OPT = dict(use_master=False, eps=1.0, weight_decay=0.0)
REL = 1e-5
TRAINER = dict(steps=4, batch=B, seq=S, lr=LR, seed=0, device="cpu",
               ckpt_every=2)
TRAINER_OPT = dict(OPT, grad_clip=1e9)


def _cfg(case):
    from repro_torch.configs import get_config, make_smoke
    arch, _, remat = case.partition("/")
    return make_smoke(get_config(arch), remat=remat or "none")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _batches(vocab):
    return [{"tokens": _tokens(10 + i, (B, S), vocab),
             "labels": _tokens(20 + i, (B, S), vocab)} for i in range(STEPS)]


def _sharded_ranks(rank, params, tmp):
    """Every sharded case on this rank; returns gathered tensors."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import LMPipeline, TokenTask
    from repro_torch.distributed import (axis_rules, distribute_tree, gather_tree,
                                         make_decode_rules, make_train_rules,
                                         use_mesh)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import cache_pspecs, param_pspecs, state_pspecs
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import init_caches, lm_decode
    from repro_torch.optim import AdamWConfig, constant_lr
    from repro_torch.train import init_train_state, make_train_step

    torch.set_num_threads(1)
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    opt = AdamWConfig(**OPT)
    for case in TRAIN_CASES:
        cfg = _cfg(case)
        state = init_train_state(params[case.partition("/")[0]], opt)
        sspec = state_pspecs(state, mesh)
        dstate = distribute_tree(state, sspec, mesh)
        step = make_train_step(cfg, opt, constant_lr(LR))
        losses = []
        with use_mesh(mesh), axis_rules(make_train_rules(False)):
            for b in _batches(cfg.vocab):
                batch = distribute_tree(
                    {k: torch.from_numpy(v) for k, v in b.items()},
                    {"tokens": ("data", None), "labels": ("data", None)}, mesh)
                dstate, metrics = step(dstate, batch)
                losses.append(float(metrics["loss"].full_tensor()))
        same = all(tuple(a.placements) == tuple(b.placements) for a, b in zip(
            jax.tree.leaves(dstate), jax.tree.leaves(distribute_tree(state, sspec, mesh))))
        out[case] = {"losses": losses, "params": gather_tree(dstate["params"]),
                     "placements_kept": same}

    for arch in ARCHS:
        cfg = _cfg(arch)
        # decode: two tokens from empty fp32 caches under the decode rules
        cell = ShapeCell("d", "decode", S, B)
        caches = init_caches(cfg, B, S, torch.float32, device="cpu")
        dcaches = distribute_tree(caches, cache_pspecs(caches, cfg, cell, mesh, False), mesh)
        dparams = distribute_tree(params[arch], param_pspecs(params[arch], mesh), mesh)
        logits = []
        with torch.no_grad(), use_mesh(mesh), \
                axis_rules(make_decode_rules(False, shard_cache_seq=False)), implicit_replication():
            for i in range(2):
                tok = distribute_tree({"tokens": torch.from_numpy(
                    _tokens(30 + i, (B, 1), cfg.vocab))}, {"tokens": ("data", None)}, mesh)
                lg, dcaches = lm_decode(dparams, dcaches, tok, i, cfg)
                logits.append(lg.full_tensor())
        out[arch]["decode"] = logits

    cfg = _cfg(ARCHS[0])
    task = TokenTask(vocab=cfg.vocab, seed=3)
    got = gather_tree(LMPipeline(task, B, S, mesh=mesh, prefetch=0).batch_at(5))
    want = LMPipeline(task, B, S, device="cpu", prefetch=0).batch_at(5)
    out["pipeline"] = all(torch.equal(got[k], want[k]) for k in want)

    # a checkpoint from the (2, 2) mesh restored on a (4, 1) one
    state = init_train_state(params[ARCHS[0]], opt)
    dstate = distribute_tree(state, state_pspecs(state, mesh), mesh)
    ck = Checkpointer(os.path.join(tmp, "ckpt"))
    ck.save(7, dstate)
    dist.barrier()
    mesh41 = make_test_mesh((4, 1), ("data", "model"), device_type="cpu")
    back = ck.restore(7, target=dstate, specs=state_pspecs(state, mesh41), mesh=mesh41)
    leaves = jax.tree.leaves(back)
    out["restore_mesh"] = {tuple(t.device_mesh.mesh.shape) for t in leaves}
    out["restore_equal"] = all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(gather_tree(back)), jax.tree.leaves(state)))
    try:
        ck.save(8, {"sharded": dstate["step"], "plain": state["step"]})
        out["mixed_refused"] = False
    except ValueError:
        out["mixed_refused"] = True

    # the launcher's data-parallel trainer: 2 steps, resumed to 4 == 4
    kw = dict(TRAINER, mesh=mesh, opt=AdamWConfig(**TRAINER_OPT))
    whole, _, _ = build_trainer(cfg, ckpt_dir=os.path.join(tmp, "whole"), **kw)
    whole.run()
    part, _, _ = build_trainer(cfg, ckpt_dir=os.path.join(tmp, "part"), **kw)
    part.cfg.total_steps = 2
    part.run()
    dist.barrier()
    resumed, _, _ = build_trainer(cfg, ckpt_dir=os.path.join(tmp, "part"), **kw)
    res = resumed.run()
    out["resume_from"] = res["final_step"]
    out["resume_equal"] = all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(gather_tree(whole.state)),
        jax.tree.leaves(gather_tree(resumed.state))))
    out["trainer"] = {"losses": [row["loss"] for row in whole.metrics_log],
                      "params": gather_tree(whole.state["params"])}
    dots, _, _ = build_trainer(_cfg(ARCHS[0] + "/dots"),
                               ckpt_dir=os.path.join(tmp, "dots"), **kw)
    dots.run()
    out["trainer_dots"] = {"losses": [row["loss"] for row in dots.metrics_log],
                           "params": gather_tree(dots.state["params"])}
    return out


def _plain_trainer(tmp):
    """``build_trainer(mesh=None)`` on the whole batch: (initial params,
    per-step losses, final params)."""
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim import AdamWConfig

    plain, _, _ = build_trainer(_cfg(ARCHS[0]), ckpt_dir=os.path.join(tmp, "plain"),
                                opt=AdamWConfig(**TRAINER_OPT), **TRAINER)
    init = plain.state["params"]
    plain.run()
    return init, [row["loss"] for row in plain.metrics_log], plain.state["params"]


def _reference(case):
    """The reference's unsharded jitted train steps and decode on its
    smoke params: (params as numpy, losses, final params, decode logits)."""
    arch, _, remat = case.partition("/")
    cfg = jmake_smoke(jget_config(arch), remat=remat or "none")
    params = jinit_params(jax.random.PRNGKey(0), cfg)
    opt = JAdamWConfig(**OPT)
    step = jax.jit(jmake_train_step(cfg, opt, jconstant_lr(LR)))
    state = jinit_train_state(params, opt)
    losses = []
    for b in _batches(cfg.vocab):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    caches = jinit_caches(cfg, B, S, jnp.float32)
    logits = []
    for i in range(2):
        lg, caches = jlm_decode(params, caches,
                                {"tokens": jnp.asarray(_tokens(30 + i, (B, 1), cfg.vocab))},
                                i, cfg)
        logits.append(np.asarray(lg))
    return params, losses, state["params"], logits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    refs = {case: _reference(case) for case in TRAIN_CASES}
    params = {arch: params_from_reference(refs[arch][0], device="cpu") for arch in ARCHS}
    ranks = run_ranks(_sharded_ranks, 4, backend="gloo", device_type="cpu",
                      init_file=tmp / "init", args=(params, str(tmp)))
    return refs, ranks, _plain_trainer(str(tmp))


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_sharded_train_steps_match_the_reference(runs, arch):
    refs, ranks, _ = runs
    _, losses, jparams, _ = refs[arch]
    for r in ranks:
        assert r[arch]["placements_kept"]
        assert np.allclose(r[arch]["losses"], losses, rtol=REL, atol=0)
    got = jax.tree.leaves(ranks[0][arch]["params"])
    want = jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= REL


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_the_reference(runs, arch):
    refs, ranks, _ = runs
    for got, want in zip(ranks[0][arch]["decode"], refs[arch][3]):
        assert _rel(got.numpy(), want) <= REL


def test_mesh_pipeline_batches_gather_to_the_host_batches(runs):
    assert all(r["pipeline"] for r in runs[1])


def test_checkpoint_from_2x2_restores_on_4x1(runs):
    for r in runs[1]:
        assert r["restore_mesh"] == {(4, 1)}
        assert r["restore_equal"]


def test_checkpoint_refuses_a_mixed_state(runs):
    assert all(r["mixed_refused"] for r in runs[1])


def test_mesh_trainer_resumes_equal(runs):
    for r in runs[1]:
        assert r["resume_from"] == 4 and r["resume_equal"]


def test_mesh_trainer_matches_the_plain_trainer(runs):
    init, losses, final = runs[2]
    assert len(losses) == TRAINER["steps"]
    for r in runs[1]:
        assert np.allclose(r["trainer"]["losses"], losses, rtol=REL, atol=0)
    got = jax.tree.leaves(runs[1][0]["trainer"]["params"])
    want = jax.tree.leaves(final)
    start = jax.tree.leaves(init)
    assert len(got) == len(want) == len(start)
    for g, w, s in zip(got, want, start):
        assert _rel((g - s).numpy(), (w - s).numpy()) <= REL


def test_mesh_trainer_under_dots_matches_the_mesh_trainer(runs):
    """The launcher's mesh trainer under ``remat="dots"`` (replicated
    DTensor state, the selective checkpoint over its products) against
    the same trainer without remat on the same ranks: the policy changes
    what is kept, not the numbers."""
    init = jax.tree.leaves(runs[2][0])
    for r in runs[1]:
        assert np.allclose(r["trainer_dots"]["losses"], r["trainer"]["losses"],
                           rtol=REL, atol=0)
    got = jax.tree.leaves(runs[1][0]["trainer_dots"]["params"])
    want = jax.tree.leaves(runs[1][0]["trainer"]["params"])
    assert len(got) == len(want) == len(init)
    for g, w, s in zip(got, want, init):
        assert _rel((g - s).numpy(), (w - s).numpy()) <= REL
