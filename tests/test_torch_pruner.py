"""The port's pruning pipeline (Algorithm 2) against the JAX package, on
the CPU.

The qwen1.5-0.5b smoke config (fp32, d_model 128, 4 layers, vocab 256)
and granite-moe-1b-a400m smoke (expert stacks) are initialised in JAX
and carried over with ``repro_torch.bridge``.  Held equal: the mask
helpers (``init_masks``, ``apply_masks``, ``count_zero_structures``,
``sparsity_report``) and the sparsity schedules; ``group_lasso`` and its
gradient on non-zero structures within 1e-5; ``IterativePruner.run``
driven by the same deterministic ``finetune_fn`` and by an ``eval_fn``
through ``lm_forward``: masks equal, ``resources_used`` within 1e-9,
``knapsack_value`` (a sum of fp32 norms) within 1e-6 relative, metrics
within 1e-4, the same rollback;
``unpack_params(pack_params(...))`` equal to the masked dense params;
``lm_forward`` on the packed result against the reference's.  The
train launcher's structures equal the reference launcher's (the
embedding and the router pruned too), and its CPU smoke runs training
and ``--prune`` end to end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import IterativePruner as JIterativePruner
from repro.core import PruneConfig as JPruneConfig
from repro.core import TPUResourceModel as JTPUResourceModel
from repro.core import apply_masks as japply_masks
from repro.core import build_structures as jbuild_structures
from repro.core import constant_step as jconstant_step
from repro.core import count_zero_structures as jcount_zero_structures
from repro.core import cubic as jcubic
from repro.core import group_lasso as jgroup_lasso
from repro.core import init_masks as jinit_masks
from repro.core import masks_from_knapsack as jmasks_from_knapsack
from repro.core import sparsity_report as jsparsity_report
from repro.data import TokenTask as JTokenTask
from repro.models import cross_entropy_loss as jcross_entropy_loss
from repro.models import init_params as jinit_params
from repro.models import lm_forward as jlm_forward
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.core import (
    BlockingSpec,
    IterativePruner,
    PruneConfig,
    TPUResourceModel,
    apply_masks,
    build_structures,
    constant_step,
    count_zero_structures,
    cubic,
    group_lasso,
    init_masks,
    make_regularizer,
    masks_from_knapsack,
    sparsity_report,
)
from repro_torch.core.masks import map_tree
from repro_torch.core.structures import iter_leaves
from repro_torch.launch import train as train_launcher
from repro_torch.models import cross_entropy_loss, lm_forward
from repro_torch.sparse import DEFAULT_EXCLUDE, DEFAULT_INCLUDE, pack_params, unpack_params

_CACHE = {}
INC, EXC = DEFAULT_INCLUDE, DEFAULT_EXCLUDE


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # under pytest-xdist, torch's intra-op threads contend with the other
    # workers' and slow these runs many times over
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(arch):
    if arch not in _CACHE:
        jcfg = jmake_smoke(jget_config(arch))
        cfg = make_smoke(get_config(arch))
        jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
        _CACHE[arch] = (jcfg, cfg, jparams, params_from_reference(jparams))
    return _CACHE[arch]


def _structures(jparams, tparams, bk=32, bn=32):
    kw = dict(include=INC, exclude=EXC, min_size=1024)
    js = jbuild_structures(jparams, JBlockingSpec(bk=bk, bn=bn), **kw)
    ts = build_structures(tparams, BlockingSpec(bk=bk, bn=bn), **kw)
    assert [i.path for i in js.infos] == [i.path for i in ts.infos]
    return js, ts


def _assert_masks_equal(jmasks, tmasks):
    want = dict(iter_leaves(params_from_reference(jmasks)))
    got = dict(iter_leaves(tmasks))
    assert sorted(want) == sorted(got)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert torch.equal(got[path], want[path]), path


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_mask_helpers_match_reference(arch):
    _, _, jparams, tparams = _model(arch)
    js, ts = _structures(jparams, tparams)
    _assert_masks_equal(jinit_masks(jparams, js), init_masks(tparams, ts))
    sel = (np.random.default_rng(1).uniform(size=ts.total_structures) < 0.6
           ).astype(np.float32)
    jm = jmasks_from_knapsack(jparams, js, sel)
    tm = masks_from_knapsack(tparams, ts, sel)
    _assert_masks_equal(jm, tm)
    assert count_zero_structures(tm, ts) == jcount_zero_structures(jm, js)
    assert count_zero_structures(tm, ts)[0] == int((sel == 0).sum())
    assert sparsity_report(tparams, tm, ts) == jsparsity_report(jparams, jm, js)
    want = params_from_reference(japply_masks(jparams, jm))
    got = apply_masks(tparams, tm)
    for (p, a), (_, b) in zip(iter_leaves(got), iter_leaves(want)):
        assert torch.equal(a, b), p
    assert apply_masks(tparams, None) is tparams


def test_sparsity_schedules_match_reference():
    for ts, js in ((constant_step([0.5, 0.3], 0.1), jconstant_step([0.5, 0.3], 0.1)),
                   (cubic([0.75, 0.5], 4), jcubic([0.75, 0.5], 4))):
        s = js_s = np.zeros(2)
        for t in range(6):
            s, js_s = ts(s, t), js(js_s, t)
            np.testing.assert_array_equal(s, js_s)
            assert ts.reached(s) == js.reached(js_s)


@pytest.mark.parametrize("arch,with_model", [("qwen1.5-0.5b", True),
                                             ("granite-moe-1b-a400m", False)])
def test_group_lasso_and_its_gradient_match_reference(arch, with_model):
    _, _, jparams, tparams = _model(arch)
    js, ts = _structures(jparams, tparams)
    kw = dict(strength=3e-3)
    jkw = dict(kw, resource_model=JTPUResourceModel(precision="fp32")) if with_model else kw
    tkw = dict(kw, resource_model=TPUResourceModel(precision="fp32")) if with_model else kw
    want, jgrad = jax.value_and_grad(lambda p: jgroup_lasso(p, js, **jkw))(jparams)
    live = map_tree(lambda t: t.detach().requires_grad_(True), tparams)
    got = group_lasso(live, ts, **tkw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(make_regularizer(ts, tkw.get("resource_model"), 3e-3)(tparams)) \
        == float(got.detach())
    jg = dict(iter_leaves(params_from_reference(jgrad)))
    for path, t in iter_leaves(live):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(g.numpy(), jg[path].numpy(), atol=1e-5, rtol=1e-5)


def test_group_lasso_gradient_at_a_zero_structure_is_nan_in_both():
    """The reference's penalty has no epsilon: a structure whose tiles
    are all zero has a NaN gradient (d sqrt(x)/dx at 0), in JAX and in
    the port alike; the other structures' gradients stay finite."""
    w = np.ones((4, 4), np.float32)
    w[:2, :2] = 0.0                                  # one dead 2x2 tile
    jp, tp = {"mlp": {"kernel": jnp.asarray(w)}}, {"mlp": {"kernel": torch.from_numpy(w)}}
    js = jbuild_structures(jp, JBlockingSpec(bk=2, bn=2), min_size=1)
    ts = build_structures(tp, BlockingSpec(bk=2, bn=2), min_size=1)
    jg = np.asarray(jax.grad(lambda p: jgroup_lasso(p, js))(jp)["mlp"]["kernel"])
    live = {"mlp": {"kernel": tp["mlp"]["kernel"].clone().requires_grad_(True)}}
    group_lasso(live, ts).backward()
    tg = live["mlp"]["kernel"].grad.numpy()
    for g in (jg, tg):
        assert np.isnan(g[:2, :2]).all() and np.isfinite(g[2:, :]).all()
    np.testing.assert_allclose(tg[2:], jg[2:], rtol=1e-6)


def _pruner_pair(arch, tolerance):
    jcfg, cfg, jparams, tparams = _model(arch)
    js, ts = _structures(jparams, tparams)
    host = JTokenTask(vocab=cfg.vocab, seed=5).batch(3, 2, 12)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in host.items()}
    jlf = jax.jit(jlm_forward, static_argnums=2)

    def jeval(p, m):
        logits, _ = jlf(japply_masks(p, m), jb, jcfg)
        return float(jcross_entropy_loss(logits, jb["labels"]))

    @torch.no_grad()
    def teval(p, m):
        logits, _ = lm_forward(apply_masks(p, m), tb, cfg)
        return float(cross_entropy_loss(logits, tb["labels"]))

    # a deterministic fine-tune: masked params, shrunk toward zero
    def jfinetune(p, m):
        return jax.tree.map(lambda x: x * 0.97, japply_masks(p, m))

    def tfinetune(p, m):
        return map_tree(lambda x: x * 0.97, apply_masks(p, m))

    sched = dict(target=[0.6, 0.6], step=0.15)
    jpr = JIterativePruner(js, JTPUResourceModel(precision="fp32"), JPruneConfig(
        schedule=jconstant_step(**sched), tolerance=tolerance, higher_is_better=False))
    tpr = IterativePruner(ts, TPUResourceModel(precision="fp32"), PruneConfig(
        schedule=constant_step(**sched), tolerance=tolerance, higher_is_better=False))
    return (jpr, jparams, jfinetune, jeval), (tpr, tparams, tfinetune, teval)


@pytest.mark.parametrize("arch,tolerance,rolls_back", [
    ("qwen1.5-0.5b", 1.0, False), ("qwen1.5-0.5b", 0.002, True),
    ("granite-moe-1b-a400m", 1.0, False)])
def test_iterative_pruner_run_matches_reference(arch, tolerance, rolls_back):
    (jpr, jparams, jft, jev), (tpr, tparams, tft, tev) = _pruner_pair(arch, tolerance)
    np.testing.assert_allclose(tpr.values(tparams), jpr.values(jparams), rtol=1e-5)
    np.testing.assert_array_equal(tpr.baseline_resources, jpr.baseline_resources)
    jp, jm, jlogs = jpr.run(jparams, jft, jev)
    tp, tm, tlogs = tpr.run(tparams, tft, tev)
    assert len(tlogs) == len(jlogs) >= 1
    for a, b in zip(tlogs, jlogs):
        assert (a.iteration, a.knapsack_method) == (b.iteration, b.knapsack_method)
        np.testing.assert_array_equal(a.sparsity, b.sparsity)
        # the values are fp32 norms whose last bits follow the summation
        # order; the selections, and so the resources used, are equal
        np.testing.assert_allclose(a.knapsack_value, b.knapsack_value, rtol=1e-6)
        np.testing.assert_allclose(a.resources_used, b.resources_used, rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.metric, b.metric, rtol=1e-4, atol=1e-4)
        assert (a.structure_sparsity, a.weight_sparsity) == \
            (b.structure_sparsity, b.weight_sparsity)
        assert a.knapsack_seconds >= 0 and a.finetune_seconds >= 0
    _assert_masks_equal(jm, tm)
    baseline = tev(tparams, init_masks(tparams, tpr.structures))
    assert (tlogs[-1].metric > baseline * (1 + tolerance)) == rolls_back
    if rolls_back:          # back to the last state within tolerance
        assert count_zero_structures(tm, tpr.structures)[0] < round(
            tlogs[-1].structure_sparsity * tpr.structures.total_structures)
    else:
        assert tlogs[-1].structure_sparsity >= 0.55
    for (p, a), (_, b) in zip(iter_leaves(tp), iter_leaves(params_from_reference(jp))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=p)


def test_prune_step_never_selects_dead_structures():
    _, _, _, tparams = _model("qwen1.5-0.5b")
    params = map_tree(lambda t: t.clone(), tparams)
    params["layers"][0]["mlp"]["w_up"]["kernel"][:32, :32] = 0.0
    ts = build_structures(params, BlockingSpec(32, 32), include=INC, exclude=EXC,
                          min_size=1024)
    pr = IterativePruner(ts, TPUResourceModel(), PruneConfig(
        schedule=constant_step([0.1, 0.1], 0.1)))
    masks, res = pr.prune_step(params, np.array([0.0, 0.0]))
    assert float(masks["layers"][0]["mlp"]["w_up"]["kernel"][:32, :32].max()) == 0.0
    assert res.x.sum() == ts.total_structures - 1


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_unpack_of_pack_is_the_masked_dense_params(arch):
    _, _, jparams, tparams = _model(arch)
    js, ts = _structures(jparams, tparams)
    sel = (np.random.default_rng(2).uniform(size=ts.total_structures) < 0.5
           ).astype(np.float32)
    masks = masks_from_knapsack(tparams, ts, sel)
    back = unpack_params(pack_params(tparams, masks, ts))
    want = apply_masks(tparams, masks)
    pairs = list(zip(iter_leaves(back), iter_leaves(want)))
    assert len(pairs) == len(list(iter_leaves(tparams)))
    for (p, a), (_, b) in pairs:
        assert a.shape == b.shape and torch.equal(a, b), p


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_packed_lm_forward_matches_reference_and_masked_dense(arch):
    jcfg, cfg, jparams, tparams = _model(arch)
    js, ts = _structures(jparams, tparams)
    sel = (np.random.default_rng(3).uniform(size=ts.total_structures) < 0.5
           ).astype(np.float32)
    jpacked = jpack_params(jparams, jmasks_from_knapsack(jparams, js, sel), js)
    masks = masks_from_knapsack(tparams, ts, sel)
    packed = pack_params(tparams, masks, ts)
    host = JTokenTask(vocab=cfg.vocab, seed=6).batch(0, 2, 12)
    want, jaux = jax.jit(jlm_forward, static_argnums=2)(
        jpacked, {"tokens": jnp.asarray(host["tokens"])}, jcfg)
    with torch.no_grad():
        tb = {"tokens": torch.from_numpy(np.array(host["tokens"]))}
        got, aux = lm_forward(packed, tb, cfg)
        dense, _ = lm_forward(apply_masks(tparams, masks), tb, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_train_launcher_prunes_the_reference_launchers_structures(arch):
    """``launch.train.prune_structures`` builds the structures the
    reference's launcher builds (``build_structures(params,
    BlockingSpec(128, 128), min_size=4096)``, the embedding and the
    router included, though at smoke widths the router, 128 x 4, is
    under the size floor): the same paths, shapes, tile grids and cost
    vectors at both precisions.  ``pack_pruned`` packs only the
    attention, MLP and expert weights; the masked embedding and router
    stay dense, and its forward equals the masked dense one."""
    jcfg, cfg, jparams, tparams = _model(arch)
    js = jbuild_structures(jparams, JBlockingSpec(bk=128, bn=128), min_size=4096)
    ts = train_launcher.prune_structures(tparams)
    paths = [i.path for i in ts.infos]
    assert paths == [i.path for i in js.infos]
    assert "embed/embedding" in paths
    for ji, ti in zip(js.infos, ts.infos):
        assert tuple(ti.shape) == tuple(ji.shape), ti.path
        assert (ti.planes, ti.grid_k, ti.grid_n) == (ji.planes, ji.grid_k, ji.grid_n)
        for prec in ("fp32", "bf16"):
            np.testing.assert_array_equal(
                TPUResourceModel(precision=prec).layer_cost(ti),
                JTPUResourceModel(precision=prec).layer_cost(ji), err_msg=ti.path)
    assert ts.total_structures == js.total_structures

    sel = (np.random.default_rng(4).uniform(size=ts.total_structures) < 0.5
           ).astype(np.float32)
    masks = masks_from_knapsack(tparams, ts, sel)
    packed = train_launcher.pack_pruned(tparams, masks)
    dense = apply_masks(tparams, masks)
    assert isinstance(packed["embed"]["embedding"], torch.Tensor)
    assert torch.equal(packed["embed"]["embedding"], dense["embed"]["embedding"])
    assert not torch.equal(dense["embed"]["embedding"], tparams["embed"]["embedding"])
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             JTokenTask(vocab=cfg.vocab, seed=6).batch(0, 2, 12).items()}
    err = train_launcher.packed_forward_error(packed, tparams, masks, batch, cfg)
    assert err["finite"] and err["max_abs_diff"] <= 1e-4 * err["max_abs_logit"], err


def test_train_launcher_smoke_trains_and_prunes(tmp_path, capsys):
    rc = train_launcher.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                              "--steps", "4", "--prune", "--batch", "4", "--seq", "32",
                              "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "done: step=4 preempted=False" in out and "loss " in out
    assert "prune it=0 " in out and "packed:" in out
    # the production mesh needs 256 ranks; this process is a world of 1
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 devices "
                                           r"but only 1 are visible"):
        train_launcher.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                             "--mesh", "single"])
