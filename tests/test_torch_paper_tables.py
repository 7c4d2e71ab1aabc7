"""The port's paper-table machinery against the JAX package's
``benchmarks/fpga_repro.py`` and tables, on the CPU.

Held equal: every row's settings in the three tables, quick and full
(blockings, per-layer models, targets, step sizes, step counts,
``min_size``, the validation batch and the training batches), read from
the reference's tables by recording what they pass to
``run_prune_experiment``; ``IterativePruner.run`` with Table V's
per-layer ``FpgaResourceModel``s on LeNet and Table II's BP-MD blocking
on the jets MLP, each package with its own ``accuracy`` and a no-op
fine-tune: masks, ``resources_used``, ``reduction()`` and structure
sparsity at every iteration.  The CPU smokes of the paper's entry
points exit 0 and print what the reference's print:
``python -m repro_torch.paper.quickstart --device cpu`` (BSR against
dense within 1e-4) and ``python -m repro_torch.paper.prune_jets --device
cpu --rf 4``; ``python -m repro_torch.paper --quick --device cpu`` runs
in ``tests/test_torch_paper_cli.py``, ``train_classifier``'s loss
trajectory in ``tests/test_torch_paper_train.py``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.fpga_repro as jfpga
from benchmarks import table2_jets as jtable2
from benchmarks import table3_svhn as jtable3
from benchmarks import table5_lenet as jtable5
from repro.core import IterativePruner as JIterativePruner
from repro.core import PruneConfig as JPruneConfig
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import build_structures as jbuild_structures
from repro.core import init_masks as jinit_masks
from repro.core import constant_step as jconstant_step
from repro.models import cnn as jcnn
from repro_torch.bridge import params_from_reference
from repro_torch.core import (
    IterativePruner,
    PruneConfig,
    build_structures,
    constant_step,
)
from repro_torch.core.structures import iter_leaves
from repro_torch.paper import fpga_repro, table2_jets, table5_lenet, table3_svhn

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # under pytest-xdist, torch's intra-op threads contend with the other
    # workers' and slow these runs many times over
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spec(b):
    return (b.bk, b.bn, b.consecutive)


def _model_fields(m):
    return (type(m).__name__, m.rf, m.precision_bits, m.fpga_strategy,
            m.multi_dim, m.precision, m.strategy)


def _reference_rows(jmod, quick, monkeypatch):
    """The keyword arguments the reference's table passes to
    ``run_prune_experiment`` for each row, and the labels it adds."""
    calls = []

    def record(**kw):
        calls.append((kw, {}))
        return calls[-1][1]

    monkeypatch.setattr(jmod, "run_prune_experiment", record)
    jmod.run(quick=quick)
    return calls


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("table", ["table2", "table3", "table5"])
def test_table_rows_match_reference(table, quick, monkeypatch):
    jmod, mod = {"table2": (jtable2, table2_jets), "table3": (jtable3, table3_svhn),
                 "table5": (jtable5, table5_lenet)}[table]
    ref = _reference_rows(jmod, quick, monkeypatch)
    ours = mod.experiments(quick, device="cpu")
    assert len(ours) == len(ref)
    for (labels, kw), (jkw, jlabels) in zip(ours, ref):
        assert labels == jlabels
        assert set(kw) - {"device"} == set(jkw), table
        for key in ("target", "step_size", "pretrain_steps", "finetune_steps",
                    "min_size"):
            assert kw[key] == jkw[key], (table, key)
        assert kw["init_fn"].__name__ == jkw["init_fn"].__name__
        assert kw["forward"].__name__ == jkw["forward"].__name__
        assert {k: _spec(v) for k, v in kw["blocking_per_layer"].items()} == \
            {k: _spec(v) for k, v in jkw["blocking_per_layer"].items()}
        m, jm = kw["models_per_layer"], jkw["models_per_layer"]
        if isinstance(jm, dict):
            assert {k: _model_fields(v) for k, v in m.items()} == \
                {k: _model_fields(v) for k, v in jm.items()}
        else:
            assert _model_fields(m) == _model_fields(jm)
        for got, want in zip(kw["val_batch"], jkw["val_batch"]):
            assert np.array_equal(got.numpy(), np.asarray(want))
        for s in (0, 10_000):
            for got, want in zip(kw["batch_fn"](s), jkw["batch_fn"](s)):
                assert np.array_equal(got.numpy(), np.asarray(want))
    if table == "table2" and not quick:
        assert [(r[0]["rf"], r[0]["mode"]) for r in ours] == [
            (2, "dsp"), (2, "md"), (4, "dsp"), (8, "dsp"), (8, "md"), (16, "dsp")]


# ---------------------------------------------------------------------------
# Algorithm 2 with the FPGA resource models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["table5-lenet", "table2-md-rf2"])
def test_pruner_with_fpga_models_matches_reference(case, monkeypatch):
    """A no-op fine-tune and each package's own ``accuracy`` on the
    table's validation batch: the same masks, resources, reductions and
    structure sparsity at every iteration, from bridged params trained
    for 20 steps in JAX (so accuracies are off the floor).  Table II's
    second full row is BP-MD at RF 2."""
    jmod, mod, row = ((jtable5, table5_lenet, 0) if case == "table5-lenet"
                      else (jtable2, table2_jets, 1))
    labels, kw = mod.experiments(False, device="cpu")[row]
    jkw = _reference_rows(jmod, False, monkeypatch)[row][0]
    assert case == "table5-lenet" or labels == {"rf": 2, "mode": "md", "bits": 18}
    jinit = getattr(jcnn, kw["init_fn"].__name__)
    jfwd = getattr(jcnn, kw["forward"].__name__)
    jparams = jinit(jax.random.PRNGKey(0))
    js = jbuild_structures(jparams, jkw["blocking_per_layer"],
                           min_size=jkw["min_size"])
    jbatch = lambda s: tuple(jnp.asarray(t.numpy()) for t in kw["batch_fn"](s))
    jparams = jfpga.train_classifier(jparams, jinit_masks(jparams, js), jfwd,
                                     jbatch, 20)
    tparams = params_from_reference(jparams)
    ts = build_structures(tparams, kw["blocking_per_layer"], min_size=kw["min_size"])
    jval, tval = jkw["val_batch"], kw["val_batch"]
    target, step = kw["target"], kw["step_size"]

    def noop(record):
        def fn(p, m):
            record.append(m)
            return p
        return fn

    jseen, tseen = [], []
    jpr = JIterativePruner(js, jkw["models_per_layer"], JPruneConfig(
        schedule=jconstant_step(list(target), step),
        tolerance=0.04))
    tpr = IterativePruner(ts, kw["models_per_layer"], PruneConfig(
        schedule=constant_step(list(target), step),
        tolerance=0.04))
    _, jmasks, jlogs = jpr.run(
        jparams, noop(jseen), lambda p, m: jfpga.accuracy(p, m, jfwd, jval))
    _, tmasks, tlogs = tpr.run(
        tparams, noop(tseen),
        lambda p, m: fpga_repro.accuracy(p, m, kw["forward"], tval))
    assert np.array_equal(tpr.baseline_resources, jpr.baseline_resources)
    assert len(tlogs) == len(jlogs) >= 2
    assert len(tseen) == len(jseen)
    for jl, tl, jm, tm in zip(jlogs, tlogs, jseen, tseen):
        assert np.array_equal(tl.sparsity, jl.sparsity)
        assert np.array_equal(tl.resources_used, jl.resources_used)
        assert np.array_equal(tl.reduction(), jl.reduction())
        assert tl.structure_sparsity == jl.structure_sparsity
        assert tl.weight_sparsity == jl.weight_sparsity
        assert tl.knapsack_method == jl.knapsack_method
        assert abs(tl.metric - jl.metric) <= 2 / len(tval[1])
        want = dict(iter_leaves(params_from_reference(jm)))
        got = dict(iter_leaves(tm))
        assert sorted(got) == sorted(want)
        for path in want:
            assert torch.equal(got[path], want[path]), (case, tl.iteration, path)
    assert jlogs[-1].structure_sparsity > 0
    want = dict(iter_leaves(params_from_reference(jmasks)))
    assert all(torch.equal(t, want[p]) for p, t in iter_leaves(tmasks))


# ---------------------------------------------------------------------------
# the examples' CPU smokes
# ---------------------------------------------------------------------------

def run_module(*args, timeout=120):
    """``python -m <args>`` from the repository root with the port on the
    path and one intra-op thread; returns its standard output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_cpu_smoke():
    out = run_module("repro_torch.paper.quickstart", "--device", "cpu")
    assert re.search(r"^structures: 64 \(cost per structure = ", out, re.M), out
    assert re.search(r"^baseline accuracy: 0\.\d{3}$", out, re.M), out
    iters = re.findall(r"^  iter \d+: acc=0\.\d{3} structure sparsity=", out, re.M)
    assert len(iters) >= 1, out
    err = re.search(r"max\|sparse-dense\|=(\S+)$", out, re.M)
    assert err and float(err.group(1)) < 1e-4, out
    assert out.rstrip().endswith("done.")


def test_prune_jets_cpu_smoke():
    out = run_module("repro_torch.paper.prune_jets", "--device", "cpu", "--rf", "4")
    assert out.startswith("DSP-aware pruning: RF=4, P=16b\n"), out
    acc = re.search(r"^baseline acc (\S+) -> pruned (\S+) \((\d+) iterations\)$",
                    out, re.M)
    assert acc and int(acc.group(3)) >= 1 and float(acc.group(1)) > 0.85, out
    dsp = re.search(r"^DSP reduction:  (\S+)x \(paper Table II, RF=4: ", out, re.M)
    assert dsp and float(dsp.group(1)) >= 1.0, out
    assert re.search(r"^BRAM reduction: \S+x$", out, re.M), out
    assert re.search(r"^structure sparsity: \S+%$", out, re.M), out


# ---------------------------------------------------------------------------
# a finding in the reference, matched by the port
# ---------------------------------------------------------------------------

def test_summary_reports_the_rolled_back_iteration_in_both(monkeypatch):
    """``run_prune_experiment`` reports the last logged iteration's
    ``reduction()`` and ``structure_sparsity`` even when that iteration
    broke the tolerance and ``IterativePruner.run`` rolled the masks back
    to the iteration before it: the reported DSP reduction belongs to
    masks the run did not keep.  Table II's RF 4 DSP row, cut to 60
    pretraining and 10 fine-tune steps, from the same ``PRNGKey(0)``
    params in both packages: each breaks the tolerance at sparsity 0.75,
    keeps the 0.60 masks and reports 0.75 and a 4x DSP reduction.  The
    port keeps the reference's summary (parity)."""
    from repro.core import count_zero_structures as jcount_zero_structures
    from repro_torch.core import count_zero_structures

    kept = {}

    class Recording(JIterativePruner):
        def run(self, *args, **kwargs):
            out = super().run(*args, **kwargs)
            kept.update(pruner=self, masks=out[1], logs=out[2])
            return out

    monkeypatch.setattr(jfpga, "IterativePruner", Recording)
    short = dict(pretrain_steps=60, finetune_steps=10)
    jkw = _reference_rows(jtable2, False, monkeypatch)[2][0]
    labels, kw = table2_jets.experiments(False, device="cpu")[2]
    assert labels == {"rf": 4, "mode": "dsp", "bits": 16}
    jparams = jkw["init_fn"](jax.random.PRNGKey(0))
    kw = dict(kw, **short, init_fn=lambda generator, device:
              params_from_reference(jparams, device))
    jres = jfpga.run_prune_experiment(**dict(jkw, **short))
    run = fpga_repro.prune_experiment(**kw)
    tres = fpga_repro.summarize(run)
    for res, logs, masks, structures, count in (
            (jres, kept["logs"], kept["masks"], kept["pruner"].structures,
             jcount_zero_structures),
            (tres, run.logs, run.masks, run.structures, count_zero_structures)):
        bound = res["baseline_acc"] * (1 - 0.04)
        assert logs[-1].metric < bound <= logs[-2].metric      # rolled back
        assert res["pruned_acc"] >= bound
        pruned, total = count(masks, structures)
        assert pruned / total == logs[-2].structure_sparsity
        assert res["structure_sparsity"] == logs[-1].structure_sparsity > pruned / total
        assert res["dsp_reduction"] == float(logs[-1].reduction()[0]) == 4.0
        assert res["dsp_reduction"] > float(logs[-2].reduction()[0])
        assert res["structure_sparsity"] == 0.75
    assert tres["dsp_reduction"] == jres["dsp_reduction"]
    assert tres["structure_sparsity"] == jres["structure_sparsity"]
