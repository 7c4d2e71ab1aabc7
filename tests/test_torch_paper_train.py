"""``train_classifier`` of the port against the JAX package's
(``benchmarks/fpga_repro.py``), on the CPU: from bridged ``PRNGKey(0)``
params under equal random structure masks, the loss after n = 1..5
masked AdamW steps agrees within 1e-4 for each paper model, and pruned
entries stay zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.fpga_repro as jfpga
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import apply_masks as japply_masks
from repro.core import build_structures as jbuild_structures
from repro.core import masks_from_knapsack as jmasks_from_knapsack
from repro.models import cnn as jcnn
from repro_torch.bridge import params_from_reference
from repro_torch.core import build_structures, masks_from_knapsack
from repro_torch.core.structures import iter_leaves
from repro_torch.data import ImageTask, JetsTask
from repro_torch.paper import fpga_repro, table2_jets, table3_svhn, table5_lenet


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # under pytest-xdist, torch's intra-op threads contend with the other
    # workers' and slow these runs many times over
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TABLES = {
    "table2": (table2_jets, JetsTask()),
    "table3": (table3_svhn, ImageTask(height=32, width=32, channels=3,
                                      classes=10, seed=5)),
    "table5": (table5_lenet, ImageTask(height=28, width=28, channels=1,
                                       classes=10, seed=11)),
}


def _bridged(jinit, blocking, min_size, keep=0.7, seed=3):
    jparams = jinit(jax.random.PRNGKey(0))
    tparams = params_from_reference(jparams)
    jblocking = {k: JBlockingSpec(bk=b.bk, bn=b.bn, consecutive=b.consecutive)
                 for k, b in blocking.items()}
    js = jbuild_structures(jparams, jblocking, min_size=min_size)
    ts = build_structures(tparams, blocking, min_size=min_size)
    sel = (np.random.default_rng(seed).uniform(size=ts.total_structures) < keep
           ).astype(np.float32)
    return (jparams, tparams, js, ts, jmasks_from_knapsack(jparams, js, sel),
            masks_from_knapsack(tparams, ts, sel))


def _jax_loss(forward, params, masks, x, y):
    logits = forward(japply_masks(params, masks), x)
    onehot = jax.nn.one_hot(y, logits.shape[-1])
    return float(-jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1)))


@pytest.mark.parametrize("table", ["table2", "table3", "table5"])
def test_train_classifier_loss_trajectory_matches_reference(table):
    """From bridged ``PRNGKey(0)`` params under equal random structure
    masks, ``train_classifier`` for n = 1..5 steps on batches of 32 from
    the table's own task: the loss on a held-out batch after each n
    within 1e-4.  (Step-1 updates are about sign(g) under Adam, so the
    gradients are held separately, within 1e-5, in
    test_torch_paper_models.py.)"""
    mod, task = TABLES[table]
    _, kw = mod.experiments(True, device="cpu")[0]
    jinit = getattr(jcnn, kw["init_fn"].__name__)
    jfwd = getattr(jcnn, kw["forward"].__name__)
    blocking = kw["blocking_per_layer"]
    jparams, tparams, _, _, jm, tm = _bridged(jinit, blocking, kw["min_size"])
    batch_fn = lambda s: task.batch(s, 32)
    x, y = batch_fn(777)
    jbatch = lambda s: tuple(jnp.asarray(t.numpy()) for t in batch_fn(s))
    got, want = [], []
    for n in range(1, 6):
        jp = jfpga.train_classifier(jparams, jm, jfwd, jbatch, n)
        tp = fpga_repro.train_classifier(tparams, tm, kw["forward"], batch_fn, n)
        want.append(_jax_loss(jfwd, jp, jm, jnp.asarray(x.numpy()),
                              jnp.asarray(y.numpy())))
        loss, _ = fpga_repro.classifier_loss_and_grads(tp, tm, kw["forward"], x, y)
        got.append(float(loss))
    assert want[-1] < want[0]                      # it does train
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # masked AdamW keeps the pruned entries at zero
    weights = dict(iter_leaves(tp))
    for path, m in iter_leaves(tm):
        assert float((weights[path] * (1 - m)).abs().max()) == 0.0, path
