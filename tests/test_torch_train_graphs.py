"""The graphed train steps (``train.graphs.GraphedTrainStep`` over
``make_train_body``, and ``paper.fpga_repro.train_classifier``'s
captured ``classifier_step_``) against their eager functional versions
and the JAX package's jitted steps.

On the CPU, at smoke sizes from seeded inputs:

* (a) the in-place train body, run eagerly, equals ``make_train_step``
  bit for bit over 5 steps (state and metrics), under remat "none",
  "full" and "dots", masked with microbatches 2, with the group-lasso
  ``reg_fn``, and on granite (MoE aux); its metrics match the reference's
  ``jax.jit(make_train_step)`` within rtol 1e-4, atol 1e-4 (the loss
  trajectory test's tolerance, same cases and weights);
* (b) ``adamw_update_`` equals ``adamw_update`` bit for bit, with and
  without master weights and masks;
* (c) ``classifier_step_`` looped equals the eager ``train_classifier``
  bit for bit for Tables II, III and V, and its held-out loss matches
  ``benchmarks/fpga_repro.train_classifier`` within atol 1e-4;
* (d) a graphed step refuses a CPU device;
* (e) ``build_trainer(device=cpu)`` runs the eager step, and under a mesh
  the launcher's step stays eager.

The ``cuda`` tests run on the card and skip here: graphed against eager
for the remat tests' three archs under each policy (fp32, losses within
1e-5 relative over 5 steps), the input state left unchanged, a held
result unchanged by later calls, a hidden sync or a host batch raising
``GraphFailure``, replays under sync-debug "error", launch counts per
replay, the schedules captured, and the classifier's graphed params
against the eager ones.
"""
import jax
import numpy as np
import pytest
import torch

import benchmarks.fpga_repro as jfpga
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import build_structures as jbuild_structures
from repro.core import make_regularizer as jmake_regularizer
from repro.models import cnn as jcnn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config, make_smoke
from repro_torch.core import BlockingSpec, build_structures, make_regularizer
from repro_torch.core.masks import map_tree
from repro_torch.core.structures import iter_leaves
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.optim import (
    AdamWConfig,
    adamw_update,
    adamw_update_,
    constant_lr,
    init_opt_state,
    linear_decay,
    warmup_cosine,
)
from repro_torch.paper import fpga_repro
from repro_torch.serving.graphs import GraphFailure
from repro_torch.train import (
    GraphedTrainStep,
    init_train_state,
    make_train_body,
    make_train_step,
    train_step_for,
)
from repro_torch.train.graphs import clone_tree
from test_torch_paper_train import TABLES, _bridged, _jax_loss
from test_torch_train import _batch, _model, _qwen_masks

REMAT_ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "jamba-v0.1-52b")
LAYERS = {"jamba-v0.1-52b": 8}     # at 4 layers jamba-smoke has no attention
METRICS = ("total_loss", "loss", "moe_aux", "lr")
GRAPHED_LOSS_TOL = 1e-5            # relative, graphed against eager on the card


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_trees_equal(a, b):
    la, lb = list(iter_leaves(a)), list(iter_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


# -- (a) the in-place body ----------------------------------------------------

@pytest.mark.parametrize("arch,remat,masked,micro,reg", [
    ("qwen1.5-0.5b", "none", False, 1, False),
    ("qwen1.5-0.5b", "full", False, 1, False),
    ("qwen1.5-0.5b", "dots", False, 1, False),
    ("qwen1.5-0.5b", "none", True, 2, False),
    ("qwen1.5-0.5b", "none", False, 1, True),
    ("granite-moe-1b-a400m", "none", False, 1, False)])
def test_train_body_equals_the_functional_step_and_the_reference(
        arch, remat, masked, micro, reg):
    jcfg, cfg, jparams, tparams = _model(arch)
    cfg = cfg.replace(remat=remat)
    jmasks, tmasks = _qwen_masks(jparams) if masked else (None, None)
    sched, jsched = warmup_cosine(1e-3, 2, 5), jwarmup_cosine(1e-3, 2, 5)
    jreg = treg = None
    if reg:
        kw = dict(include=("mlp", "attn"), min_size=1024)
        jreg = jmake_regularizer(jbuild_structures(
            jparams, JBlockingSpec(bk=32, bn=32), **kw), strength=1e-2)
        treg = make_regularizer(build_structures(
            tparams, BlockingSpec(bk=32, bn=32), **kw), strength=1e-2)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(), jsched, reg_fn=jreg,
                                     microbatches=micro))
    step = make_train_step(cfg, AdamWConfig(), sched, reg_fn=treg, microbatches=micro)
    body = make_train_body(cfg, AdamWConfig(), sched, reg_fn=treg, microbatches=micro)
    jst = jinit_train_state(jparams, JAdamWConfig(), masks=jmasks)
    st = init_train_state(tparams, AdamWConfig(), masks=tmasks)
    inplace = clone_tree(st)
    leaves = [t for _, t in iter_leaves(inplace)]
    jl, tl = [], []
    for s in range(5):
        jb, tb = _batch(cfg.vocab, b=4, s=16, step=s)
        jst, jm = jstep(jst, jb)
        st, m = step(st, tb)
        got = body(inplace, tb)
        assert list(got) == list(m)
        for k in m:
            assert torch.equal(got[k], m[k]), k
        jl.append([float(jm[k]) for k in METRICS])
        tl.append([float(got[k]) for k in METRICS])
    _assert_trees_equal(inplace, st)
    # in place: the body's state keeps its tensors
    assert all(a is b for a, (_, b) in zip(leaves, iter_leaves(inplace)))
    assert int(inplace["step"]) == 5 and int(inplace["opt"]["count"]) == 5
    np.testing.assert_allclose(np.array(tl), np.array(jl), rtol=1e-4, atol=1e-4)


# -- (b) AdamW in place ---------------------------------------------------------

@pytest.mark.parametrize("use_master", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_adamw_update_in_place_equals_the_functional_update(use_master, masked):
    rng = np.random.default_rng(7)
    dtype = torch.bfloat16 if use_master else torch.float32
    shapes = {"a": {"kernel": (8, 6), "bias": (6,)}, "b": [(4, 4), (3,)]}

    def tree(fn, node=shapes):
        if isinstance(node, dict):
            return {k: tree(fn, v) for k, v in node.items()}
        if isinstance(node, list):
            return [tree(fn, v) for v in node]
        return fn(node)

    params = tree(lambda s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype))
    masks = None
    if masked:
        masks = tree(lambda s: torch.from_numpy(
            (rng.uniform(size=s) < 0.6).astype(np.float32)))
        masks["a"]["bias"] = None
    cfg = AdamWConfig(use_master=use_master)
    state = init_opt_state(params, cfg)
    p2, s2 = clone_tree(params), clone_tree(state)
    for step in range(3):
        grads = tree(lambda s: torch.from_numpy(
            (rng.normal(size=s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)).to(dtype))
        lr = torch.tensor(1e-2 * (step + 1), dtype=torch.float32)
        params, state = adamw_update(params, grads, state, cfg, lr, masks=masks)
        assert adamw_update_(p2, grads, s2, cfg, lr, masks=masks) is None
        _assert_trees_equal(p2, params)
        _assert_trees_equal(s2, state)
    assert ("master" in s2) == use_master and int(s2["count"]) == 3


# -- (c) the classifier step ------------------------------------------------------

@pytest.mark.parametrize("table", ["table2", "table3", "table5"])
def test_classifier_step_equals_train_classifier_and_the_reference(table):
    mod, task = TABLES[table]
    _, kw = mod.experiments(True, device="cpu")[0]
    jfwd = getattr(jcnn, kw["forward"].__name__)
    jinit = getattr(jcnn, kw["init_fn"].__name__)
    jparams, tparams, _, _, jm, tm = _bridged(jinit, kw["blocking_per_layer"],
                                              kw["min_size"])
    batch_fn = lambda s: task.batch(s, 32)
    steps, lr = 4, 5e-3
    want = fpga_repro.train_classifier(tparams, tm, kw["forward"], batch_fn, steps, lr=lr)
    opt_cfg = AdamWConfig(use_master=False, weight_decay=0.0)
    p = clone_tree(tparams)
    opt = init_opt_state(p, opt_cfg)
    losses = []
    for s in range(steps):
        x, y = batch_fn(s)
        losses.append(fpga_repro.classifier_step_(p, opt, tm, kw["forward"], x, y,
                                                  opt_cfg, lr))
    _assert_trees_equal(p, want)
    assert all(t.shape == () and torch.isfinite(t) for t in losses)
    x, y = batch_fn(777)
    jp = jfpga.train_classifier(jparams, jm, jfwd,
                                lambda s: tuple(jax.numpy.asarray(t.numpy())
                                                for t in batch_fn(s)), steps, lr=lr)
    got, _ = fpga_repro.classifier_loss_and_grads(p, tm, kw["forward"], x, y)
    ref = _jax_loss(jfwd, jp, jm, jax.numpy.asarray(x.numpy()),
                    jax.numpy.asarray(y.numpy()))
    np.testing.assert_allclose(float(got), ref, rtol=0, atol=1e-4)


# -- (d), (e) where the graph runs -------------------------------------------------

def test_graphed_step_refuses_a_cpu_device():
    _, cfg, _, _ = _model("qwen1.5-0.5b")
    body = make_train_body(cfg, AdamWConfig(), constant_lr(1e-3))
    with pytest.raises(ValueError, match="CUDA device"):
        GraphedTrainStep(body, torch.device("cpu"))


def test_the_launcher_steps_eagerly_on_the_cpu_and_under_a_mesh(tmp_path):
    cfg = make_smoke(get_config("qwen1.5-0.5b"))
    trainer, pipe, opt_cfg = launch_train.build_trainer(
        cfg, steps=2, batch=2, seq=16, lr=1e-3, seed=0, device=torch.device("cpu"),
        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=0)
    assert not isinstance(trainer.step_fn, GraphedTrainStep)
    start = clone_tree(trainer.state)
    got, _ = trainer.step_fn(trainer.state, pipe.batch_at(0))
    want, _ = make_train_step(cfg, opt_cfg, warmup_cosine(1e-3, 1, 2))(
        start, pipe.batch_at(0))
    _assert_trees_equal(got, want)
    # a mesh keeps the eager step even on the card: nothing is captured
    step = train_step_for(cfg, opt_cfg, constant_lr(1e-3), torch.device("cuda"),
                          mesh=object())
    assert not isinstance(step, GraphedTrainStep)
    got, _ = step(start, pipe.batch_at(0))
    want, _ = make_train_step(cfg, opt_cfg, constant_lr(1e-3))(start, pipe.batch_at(0))
    _assert_trees_equal(got, want)


# -- on the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_model(arch, remat, dev):
    cfg = make_smoke(get_config(arch), n_layers=LAYERS.get(arch, 4), remat=remat)
    params = init_params(cfg, seed=0, device=dev)
    return cfg, init_train_state(params, AdamWConfig())


def _card_batch(vocab, s, dev):
    _, tb = _batch(vocab, b=4, s=16, step=s)
    return {k: v.to(dev) for k, v in tb.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_graphed_step_equals_the_eager_step(arch, remat):
    dev = _card()
    cfg, st = _card_model(arch, remat, dev)
    sched = warmup_cosine(1e-3, 2, 5)
    eager = make_train_step(cfg, AdamWConfig(), sched)
    graphed = GraphedTrainStep(make_train_body(cfg, AdamWConfig(), sched), dev)
    a, b = st, st
    for s in range(5):
        batch = _card_batch(cfg.vocab, s, dev)
        a, ma = eager(a, batch)
        b, mb = graphed(b, batch)
        for k in METRICS:
            want, got = float(ma[k]), float(mb[k])
            assert abs(got - want) <= GRAPHED_LOSS_TOL * max(abs(want), 1e-12), (s, k)
    stats = graphed.stats()
    assert stats["captures"] == 1 and stats["replays"] == [4]
    assert int(b["step"]) == 5


@pytest.mark.cuda
def test_graphed_step_is_functional():
    """The input state is left as it was, a held result is not touched by
    later calls, and two calls from one state give one result."""
    dev = _card()
    cfg, st = _card_model("qwen1.5-0.5b", "dots", dev)
    graphed = GraphedTrainStep(make_train_body(cfg, AdamWConfig(), constant_lr(1e-3)),
                               dev)
    before = clone_tree(st)
    first, _ = graphed(st, _card_batch(cfg.vocab, 0, dev))       # the capture
    held = clone_tree(first)
    second, _ = graphed(first, _card_batch(cfg.vocab, 1, dev))   # a replay
    third, _ = graphed(st, _card_batch(cfg.vocab, 0, dev))       # again from st
    torch.cuda.synchronize()
    _assert_trees_equal(st, before)
    _assert_trees_equal(first, held)
    _assert_trees_equal(third, first)
    fresh = {id(t) for _, t in iter_leaves(third)}
    assert not fresh & {id(t) for _, t in iter_leaves(first)}
    assert int(second["step"]) == 2


@pytest.mark.cuda
def test_graphed_step_raises_on_syncs_and_host_batches():
    """A body that reads a value back to the host fails to capture, a
    host batch is refused, and the replays (with their copies) run under
    sync-debug "error", which is restored after each call."""
    from repro_torch.kernels import _build
    dev = _card()
    cfg, st = _card_model("qwen1.5-0.5b", "none", dev)
    body = make_train_body(cfg, AdamWConfig(), constant_lr(1e-3))

    def syncing(state, batch):
        metrics = body(state, batch)
        float(metrics["loss"])
        return metrics

    with pytest.raises(GraphFailure):
        GraphedTrainStep(syncing, dev)(st, _card_batch(cfg.vocab, 0, dev))
    graphed = GraphedTrainStep(body, dev)
    _, tb = _batch(cfg.vocab, b=4, s=16, step=0)
    with pytest.raises(GraphFailure):
        graphed(st, tb)
    prev = torch.cuda.get_sync_debug_mode()
    out, _ = graphed(st, _card_batch(cfg.vocab, 0, dev))
    counts = dict(_build.launch_counts)
    for s in (1, 2):
        out, _ = graphed(out, _card_batch(cfg.vocab, s, dev))
    assert torch.cuda.get_sync_debug_mode() == prev
    stats = graphed.stats()
    # dense training launches none of the port's kernels
    assert stats["replays"][-1] == 2 and stats["launches_per_replay"][-1] == {}
    assert dict(_build.launch_counts) == counts
    assert graphed.pool_bytes() is None or graphed.pool_bytes() > 0


@pytest.mark.cuda
def test_schedules_capture():
    """The schedules compute from the device step tensor with no host
    copy: each is captured and replayed."""
    from repro_torch.serving.graphs import capture
    dev = _card()
    step = torch.zeros((), dtype=torch.int32, device=dev)
    for fn in (warmup_cosine(3e-4, 3, 20), linear_decay(1e-3, 7), constant_lr(5e-4)):
        want = [float(fn(torch.tensor(s, dtype=torch.int32))) for s in range(6)]
        step.zero_()
        first, graph = capture(lambda: fn(step), dev, torch.cuda.graph_pool_handle(),
                               "schedule")
        got = [float(first)]
        for s in range(1, 6):
            step.fill_(s)
            got.append(float(graph.replay()))
        assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["table2", "table3", "table5"])
def test_graphed_classifier_equals_the_eager_one(table, monkeypatch):
    """cuDNN's deterministic convolutions, so that what differs is the
    graph and not the library's choice of a reduction order."""
    dev = _card()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    mod, task = TABLES[table]
    _, kw = mod.experiments(True, device="cpu")[0]
    _, tparams, _, _, _, tm = _bridged(getattr(jcnn, kw["init_fn"].__name__),
                                       kw["blocking_per_layer"], kw["min_size"])
    params = map_tree(lambda t: t.to(dev), tparams)
    masks = map_tree(lambda t: None if t is None else t.to(dev), tm)
    batch_fn = lambda s: task.batch(s, 32)
    log = []
    want = fpga_repro.train_classifier(params, masks, kw["forward"], batch_fn, 6,
                                       cuda_graphs=False)
    got = fpga_repro.train_classifier(params, masks, kw["forward"], batch_fn, 6,
                                      graph_log=log)
    assert [r["replays"] for r in log] == [5]
    for (path, g), (_, w) in zip(iter_leaves(got), iter_leaves(want)):
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)
        assert err <= 1e-5, path


# -- the lint's registry ------------------------------------------------------------

def test_lint_registry_covers_the_train_captures(tmp_path):
    """The captured train bodies are registered and held to the host-sync
    rule: the port's LM body and classifier step reach the forward, the
    loss and AdamW, and a pull inside a fixture body is a finding."""
    import textwrap
    from pathlib import Path

    from repro_torch.analysis import lint
    from repro_torch.analysis.rules import all_rules
    root = Path(__file__).resolve().parents[1]
    index = lint.build_index(root, [root / p for p in lint.DEFAULT_SCAN_PATHS])
    assert {"train_body", "classifier_step_"} <= set(index.jits_by_name)
    reached = {fi.qualname for m in index.modules for fi in m.functions
               if index.is_train_captured(fi)}
    assert {"make_train_body.train_body", "classifier_step_", "lm_forward",
            "adamw_update", "adamw_update_", "cross_entropy_loss",
            "classifier_loss_and_grads"} <= reached
    (tmp_path / "fixture.py").write_text(textwrap.dedent("""
        import torch

        def make_train_body(cfg):
            def train_body(state, batch):
                loss = _loss(state, batch)
                return {"loss": loss}
            return train_body

        def _loss(state, batch):
            x = torch.sum(batch["tokens"])
            print(x.item())
            return x
        """))
    fixture = lint.build_index(tmp_path, [tmp_path])
    findings, _ = lint.run_rules(fixture, all_rules(), enabled={"host-sync"})
    assert [(f.symbol, "captured train bodies" in f.message) for f in findings] == [
        ("_loss", True)]
