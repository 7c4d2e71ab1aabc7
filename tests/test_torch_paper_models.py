"""The port's paper models, data and FPGA resource vectors against the
JAX package, on the CPU.

Held equal, bit for bit: ``JetsTask`` and ``ImageTask`` batches at the
tables' seeds and shapes; ``fpga_dsp_bram``, ``bram_c`` and
``FpgaResourceModel.structure_cost`` at every blocking and model the
three tables use.  Held within 1e-5 (normalized by max(1, max|ref|)):
each model's forward from bridged ``PRNGKey(0)`` params at B 1 and 8,
dense and under random structure masks; the gradient of the tables'
loss for every leaf against ``jax.grad``; the forward on packed FC
kernels at the paper's blockings (the plain BSR version on the CPU)
against the JAX package's packed forward and the masked dense one,
with no kernel launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.fpga_repro import FpgaResourceModel as JFpgaResourceModel
from benchmarks.fpga_repro import bram_c as jbram_c
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import TPUResourceModel as JTPUResourceModel
from repro.core import apply_masks as japply_masks
from repro.core import build_structures as jbuild_structures
from repro.core import masks_from_knapsack as jmasks_from_knapsack
from repro.core import pack_bsr as jpack_bsr
from repro.data import ImageTask as JImageTask
from repro.data import JetsTask as JJetsTask
from repro.models import cnn as jcnn
from repro_torch.bridge import params_from_reference
from repro_torch.core import (
    BlockingSpec,
    TPUResourceModel,
    apply_masks,
    build_structures,
    masks_from_knapsack,
    pack_bsr,
)
from repro_torch.core.masks import _get_path
from repro_torch.data import ImageTask, JetsTask
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import cnn
from repro_torch.paper import table2_jets, table3_svhn, table5_lenet
from repro_torch.paper.fpga_repro import (
    FpgaResourceModel,
    bram_c,
    classifier_loss_and_grads,
)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # under pytest-xdist, torch's intra-op threads contend with the other
    # workers' and slow these runs many times over
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# the tables' blockings per model: one spec or per-path specs, and min_size
def _lenet_blocking(jax_side: bool):
    blocking = {}
    for layer in cnn.LENET_LAYER_CFG:
        if layer.strategy == "latency":
            bk, c = 1, 1
        else:
            c = bram_c(layer.precision_bits)
            bk = layer.rf * c
        blocking[f"{layer.name}/kernel"] = (bk, 1, c)
    blocking["default"] = (1, 1, 1)
    spec = JBlockingSpec if jax_side else BlockingSpec
    return {k: spec(bk=a, bn=b, consecutive=c) for k, (a, b, c) in blocking.items()}


MODELS = {
    # name: (jax init, jax forward, torch forward, input shape, blocking, min_size)
    "jets-mlp": (jcnn.init_jets_mlp, jcnn.jets_mlp_forward, cnn.jets_mlp_forward,
                 (16,), lambda j: (JBlockingSpec if j else BlockingSpec)(bk=4, bn=1),
                 256),
    "jets-mlp-md": (jcnn.init_jets_mlp, jcnn.jets_mlp_forward, cnn.jets_mlp_forward,
                    (16,), lambda j: (JBlockingSpec if j else BlockingSpec)(
                        bk=4, bn=1, consecutive=2), 256),
    "svhn-cnn": (jcnn.init_svhn_cnn, jcnn.svhn_cnn_forward, cnn.svhn_cnn_forward,
                 (32, 32, 3), lambda j: (JBlockingSpec if j else BlockingSpec)(
                     bk=27, bn=1), 128),
    "lenet-fmnist": (jcnn.init_lenet, jcnn.lenet_forward, cnn.lenet_forward,
                     (28, 28, 1), _lenet_blocking, 50),
}
_CACHE = {}


def _cfg_fields(c):
    return (c.name, c.rf, c.strategy, c.precision_bits)


def _model(name):
    """(jax params, torch params, jax structures, torch structures)."""
    if name not in _CACHE:
        jinit, _, _, _, blocking, min_size = MODELS[name]
        jparams = jinit(jax.random.PRNGKey(0))
        tparams = params_from_reference(jparams)
        js = jbuild_structures(jparams, blocking(True), min_size=min_size)
        ts = build_structures(tparams, blocking(False), min_size=min_size)
        assert [(i.path, i.grid_k, i.grid_n, i.planes) for i in js.infos] == \
            [(i.path, i.grid_k, i.grid_n, i.planes) for i in ts.infos]
        _CACHE[name] = (jparams, tparams, js, ts)
    return _CACHE[name]


def _random_masks(name, seed=1, keep=0.6):
    jparams, tparams, js, ts = _model(name)
    sel = (np.random.default_rng(seed).uniform(size=ts.total_structures) < keep
           ).astype(np.float32)
    return (jmasks_from_knapsack(jparams, js, sel),
            masks_from_knapsack(tparams, ts, sel))


def _inputs(name, b, seed=0):
    shape = MODELS[name][3]
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, *shape)).astype(np.float32), \
        rng.integers(0, 10 if "jets" not in name else 5, size=b).astype(np.int32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task,batches", [
    ("jets", (256, 2048)),
    ("svhn", (128, 1024)),
    ("lenet", (128, 1024)),
])
def test_batches_are_bit_equal_to_the_reference(task, batches):
    """The tables' tasks at their seeds and shapes: training steps
    0/1/2/179, fine-tune steps from 10 000, the validation batch at
    99 999."""
    if task == "jets":
        pair = (JJetsTask(), JetsTask())
    elif task == "svhn":
        kw = dict(height=32, width=32, channels=3, classes=10, seed=5)
        pair = (JImageTask(**kw), ImageTask(**kw))
    else:
        kw = dict(height=28, width=28, channels=1, classes=10, seed=11)
        pair = (JImageTask(**kw), ImageTask(**kw))
    train_b, val_b = batches
    for step, b in [(0, train_b), (1, train_b), (2, train_b), (179, train_b),
                    (10_000, train_b), (10_001, train_b), (99_999, val_b)]:
        (jx, jy), (tx, ty) = pair[0].batch(step, b), pair[1].batch(step, b)
        assert tx.device.type == "cpu" and ty.device.type == "cpu"
        assert tx.dtype == torch.float32 and ty.dtype == torch.int32
        assert np.array_equal(tx.numpy(), np.asarray(jx)), (task, step)
        assert np.array_equal(ty.numpy(), np.asarray(jy)), (task, step)


# ---------------------------------------------------------------------------
# resource vectors
# ---------------------------------------------------------------------------

def test_fpga_dsp_bram_equals_reference():
    for bits in (8, 9, 10, 16, 18):
        for rf in range(1, 28):
            for strategy in ("resource", "latency"):
                want = JTPUResourceModel.fpga_dsp_bram(bits, rf, strategy)
                got = TPUResourceModel.fpga_dsp_bram(bits, rf, strategy)
                assert got == want, (bits, rf, strategy)
    assert TPUResourceModel.fpga_dsp_bram(9, 4) == (0.0, 4 * 9 / (36 * 1024))
    assert TPUResourceModel.fpga_dsp_bram(16, 4, "latency") == (1.0, 0.0)


def test_bram_c_equals_reference():
    assert [bram_c(b) for b in range(1, 37)] == [jbram_c(b) for b in range(1, 37)]


def _table_models():
    """(blocking, model) of every layer of every row of the three tables,
    quick and full."""
    pairs = []
    for mod in (table2_jets, table3_svhn, table5_lenet):
        for quick in (True, False):
            for _, kw in mod.experiments(quick, device="cpu"):
                blocking, models = kw["blocking_per_layer"], kw["models_per_layer"]
                if isinstance(models, FpgaResourceModel):
                    models = {k: models for k in blocking}
                for path, spec in blocking.items():
                    pairs.append((spec, models.get(path, models.get("default"))))
    return pairs


def test_structure_costs_equal_reference():
    pairs = _table_models()
    assert len(pairs) >= 20
    seen = set()
    for spec, m in pairs:
        jm = JFpgaResourceModel(rf=m.rf, precision_bits=m.precision_bits,
                                fpga_strategy=m.fpga_strategy,
                                multi_dim=m.multi_dim)
        jspec = JBlockingSpec(bk=spec.bk, bn=spec.bn, consecutive=spec.consecutive)
        got, want = m.structure_cost(spec), jm.structure_cost(jspec)
        assert got.dtype == want.dtype and np.array_equal(got, want), (spec, m)
        seen.add((m.rf, m.precision_bits, m.fpga_strategy, m.multi_dim))
    # DSP-aware 16-bit, BRAM-aware 18-bit and LeNet's latency layers
    assert (4, 16, "resource", False) in seen
    assert (2, 18, "resource", True) in seen
    assert (25, 18, "resource", True) in seen
    assert (1, 18, "latency", False) in seen


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("name", ["jets-mlp", "svhn-cnn", "lenet-fmnist"])
def test_forward_matches_reference(name, b, masked):
    _, jfwd, tfwd, *_ = MODELS[name]
    jparams, tparams, _, _ = _model(name)
    if masked:
        jm, tm = _random_masks(name)
        jparams, tparams = japply_masks(jparams, jm), apply_masks(tparams, tm)
    x, _ = _inputs(name, b)
    want = np.asarray(jax.jit(jfwd)(jparams, jnp.asarray(x)))
    got = tfwd(tparams, torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(_np(got), want) <= TOL


def test_conv_and_pool_keep_the_reference_layout():
    """NHWC activations, HWIO kernels, floor pooling 13 -> 6, and the
    flatten before fc_1 in (H, W, C) order: an NCHW flatten would feed
    fc_1 permuted rows and only this comparison would show it."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 13, 11, 5)).astype(np.float32)
    p = {"kernel": rng.normal(size=(3, 3, 5, 7)).astype(np.float32),
         "bias": rng.normal(size=(7,)).astype(np.float32)}
    jy = jcnn.conv2d({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    ty = cnn.conv2d({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x))
    assert tuple(ty.shape) == (2, 11, 9, 7)
    assert _rel(_np(ty), np.asarray(jy)) <= TOL
    jp = jcnn.maxpool(jnp.asarray(x))
    tp = cnn.maxpool(torch.from_numpy(x))
    assert tuple(tp.shape) == (2, 6, 5, 5)
    assert np.array_equal(_np(tp), np.asarray(jp))
    flat = tp.reshape(2, -1)
    assert np.array_equal(_np(flat), np.asarray(jp).reshape(2, -1))


def test_model_registry_and_init():
    assert sorted(cnn.PAPER_MODELS) == sorted(jcnn.PAPER_MODELS)
    with pytest.raises(KeyError):
        cnn.paper_model("resnet")
    for name in cnn.PAPER_MODELS:
        init, _, shape = cnn.paper_model(name)
        jinit, _, jshape = jcnn.paper_model(name)
        assert shape == jshape
        g = torch.Generator().manual_seed(0)
        tp = init(generator=g, device="cpu")
        jp = jinit(jax.random.PRNGKey(0))
        tl = {k: {kk: tuple(v.shape) for kk, v in d.items()} for k, d in tp.items()}
        jl = {k: {kk: tuple(v.shape) for kk, v in d.items()} for k, d in jp.items()}
        assert tl == jl, name
        assert all(float(d["bias"].abs().max()) == 0.0 for d in tp.values())
    assert [_cfg_fields(c) for c in cnn.LENET_LAYER_CFG] == \
        [_cfg_fields(c) for c in jcnn.LENET_LAYER_CFG]


def _jax_loss(forward, masks, x, y):
    def loss_fn(p):
        logits = forward(japply_masks(p, masks), x)
        onehot = jax.nn.one_hot(y, logits.shape[-1])
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
    return loss_fn


@pytest.mark.parametrize("name", ["jets-mlp", "svhn-cnn", "lenet-fmnist"])
def test_loss_gradients_match_jax_grad(name):
    _, jfwd, tfwd, *_ = MODELS[name]
    jparams, tparams, _, _ = _model(name)
    jm, tm = _random_masks(name, seed=2)
    x, y = _inputs(name, 8, seed=4)
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(jfwd, jm, jnp.asarray(x),
                                                  jnp.asarray(y))))(jparams)
    tl, tg = classifier_loss_and_grads(tparams, tm, tfwd, torch.from_numpy(x),
                                       torch.from_numpy(y))
    assert abs(float(tl) - float(jl)) <= TOL * max(1.0, abs(float(jl)))
    for layer, leaves in jg.items():
        for leaf, g in leaves.items():
            assert tg[layer][leaf].shape == g.shape
            assert _rel(_np(tg[layer][leaf]), np.asarray(g)) <= TOL, (layer, leaf)


def _packed(name, jparams, tparams, jm, tm, js, ts):
    """Both packages' params with every pruned FC kernel packed at its
    structures' blocking, the other leaves masked dense."""
    jp, tp = japply_masks(jparams, jm), apply_masks(tparams, tm)
    packed = []
    for ji, ti in zip(js.infos, ts.infos):
        layer = ti.path.split("/")[0]
        if not layer.startswith("fc_"):
            continue                    # conv kernels stay masked dense
        jp = {**jp, layer: {**jp[layer], "kernel": jpack_bsr(
            np.asarray(jparams[layer]["kernel"]), ji.blocking,
            mask=np.asarray(_get_path(jm, ji.path)))}}
        tp = {**tp, layer: {**tp[layer], "kernel": pack_bsr(
            tparams[layer]["kernel"], ti.blocking, mask=_get_path(tm, ti.path))}}
        packed.append(layer)
    return jp, tp, packed


@pytest.mark.parametrize("name,n_packed", [("jets-mlp", 3), ("jets-mlp-md", 3),
                                           ("svhn-cnn", 3), ("lenet-fmnist", 3)])
def test_packed_forward_matches_reference_and_masked_dense(name, n_packed):
    """Tiles (4,1), (4,1) with consecutive 2, (27,1) with K 96 padded to
    4 tiles, LeNet's (50,1)/(24,1) with consecutive 2 and (1,1): jets'
    fc_4 (160 weights) is under min_size 256 and stays dense."""
    _, jfwd, tfwd, *_ = MODELS[name]
    jparams, tparams, js, ts = _model(name)
    jm, tm = _random_masks(name, seed=5, keep=0.4)
    jp, tp, packed = _packed(name, jparams, tparams, jm, tm, js, ts)
    assert len(packed) == n_packed
    x, _ = _inputs(name, 8, seed=6)
    reset_launch_counts()
    got = _np(tfwd(tp, torch.from_numpy(x)))
    assert all(v == 0 for v in launch_counts.values()), dict(launch_counts)
    want_ref = np.asarray(jfwd(jp, jnp.asarray(x)))
    want_dense = _np(tfwd(apply_masks(tparams, tm), torch.from_numpy(x)))
    assert _rel(got, want_ref) <= TOL
    assert _rel(got, want_dense) <= TOL
