"""The expert-parallel all-to-all MoE of the port against the reference's.

The reference runs once, in one JAX subprocess on 8 fake CPU devices
(the device count must be set before JAX starts): ``moe_alltoall_apply``
at meshes (1, 2) and (2, 2) on ("data", "model"), dense and packed
(``BSRPlanes`` at 16x16 tiles, about 60 % kept), at capacity factors 8.0
(no drops) and 1.0 (drops), and granite smoke's ``lm_forward`` and
``lm_prefill`` with ``moe_impl="alltoall"`` under the (1, 2) mesh and the
train rules, and granite's first MoE layer at the config's own capacity
factor.  It writes its inputs and outputs to one ``.npz``.  The port runs
the same inputs on gloo ranks spawned per mesh (one spawn per world
size): y within 1e-5 and aux within 1e-6, at cf 1.0 showing that the
same slots drop, with every model rank holding the same y; at a (1, 1)
mesh the all-to-all equals the port's ``moe_apply`` at cf E/k; its
gradients through the exchange equal ``moe_apply``'s on the unsharded
stack.
"""
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import build_structures as jbuild_structures
from repro.core import masks_from_knapsack as jmasks_from_knapsack
from repro.models.transformer import init_params as jinit_params
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.core import BSRPlanes
from repro_torch.distributed import axis_rules, make_train_rules, run_ranks, use_mesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import init_caches, lm_forward, lm_prefill
from repro_torch.models.moe import moe_apply
from repro_torch.models.moe_alltoall import (_expert_ffn, alltoall_available,
                                             moe_alltoall_apply)
from repro_torch.sparse import planes_pspec, shard_experts, unpack_params

ROOT = Path(__file__).resolve().parents[1]
E, K, D, F = 4, 2, 32, 64
MESHES = ((1, 2), (2, 2))
KINDS = ("dense", "packed")
CFS = (8.0, 1.0)
CASES = [(mesh, kind, cf) for mesh in MESHES for kind in KINDS for cf in CFS]
GRANITE = dict(batch=2, seq=12)
# granite smoke's logits against the reference's at cf E/k: under drops the
# reference's model replicas of the residual stream diverge and its
# GSPMD-sharded layers mix them (ROADMAP §3), where the port's replicas all
# take model rank 0's MoE output.  At the config's own cf the port's ranks
# are held equal, and its first MoE layer to the reference's.
GRANITE_CF = E / K
GRANITE_OWN_CF = get_config("granite-moe-1b-a400m").capacity_factor
Y_TOL, AUX_TOL = 1e-5, 1e-6

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config, make_smoke
    from repro.core import BlockingSpec, build_structures
    from repro.distributed.sharding import axis_rules, make_train_rules, use_mesh
    from repro.launch.mesh import make_test_mesh
    from repro.models.moe_alltoall import moe_alltoall_apply
    from repro.models.transformer import init_caches, init_params, lm_forward, lm_prefill
    from repro.sparse import pack_params

    E, K, D, F = %(ekdf)r
    inp = dict(np.load(sys.argv[1]))
    names = ("experts_up", "experts_gate", "experts_down")
    p = {"router": {"kernel": jnp.asarray(inp["p/router"])},
         **{n: jnp.asarray(inp[f"p/{n}"]) for n in names}}
    masks = {"router": {"kernel": jnp.ones_like(p["router"]["kernel"])},
             **{n: jnp.asarray(inp[f"mask/{n}"]) for n in names}}
    packed = pack_params(p, masks, build_structures(
        p, BlockingSpec(bk=16, bn=16), min_size=256))
    out = {}
    for mesh_shape in %(meshes)r:
        mesh = make_test_mesh(mesh_shape, ("data", "model"))
        with use_mesh(mesh), axis_rules(make_train_rules(False)):
            xs = jax.device_put(jnp.asarray(inp["x"]),
                                NamedSharding(mesh, P("data", None, None)))
            for kind, tree in (("dense", p), ("packed", packed)):
                for cf in %(cfs)r:
                    y, aux = jax.jit(lambda pp, xx, cf=cf: moe_alltoall_apply(
                        pp, xx, num_experts=E, top_k=K, capacity_factor=cf))(tree, xs)
                    tag = f"{mesh_shape[0]}x{mesh_shape[1]}/{kind}/{cf}"
                    out[f"y/{tag}"] = np.asarray(y)
                    out[f"aux/{tag}"] = np.asarray(aux)

    cfg = make_smoke(get_config("granite-moe-1b-a400m"), moe_impl="alltoall",
                     capacity_factor=%(gcf)r)
    params = init_params(jax.random.PRNGKey(0), cfg)
    tokens = jnp.asarray(inp["tokens"])
    mesh = make_test_mesh((1, 2), ("data", "model"))
    with use_mesh(mesh), axis_rules(make_train_rules(False)):
        logits, aux = jax.jit(lambda pp, t: lm_forward(pp, {"tokens": t}, cfg))(
            params, tokens)
        plog, _ = jax.jit(lambda pp, c, t: lm_prefill(pp, c, {"tokens": t}, cfg))(
            params, init_caches(cfg, *tokens.shape, jnp.float32), tokens)
    out["granite/forward"] = np.asarray(logits)
    out["granite/aux"] = np.asarray(aux["moe_aux"])
    out["granite/prefill"] = np.asarray(plog)
    own = make_smoke(get_config("granite-moe-1b-a400m"))
    with use_mesh(mesh), axis_rules(make_train_rules(False)):
        gx = jax.device_put(jnp.asarray(inp["granite_x"]),
                            NamedSharding(mesh, P("data", None, None)))
        for cf in (own.capacity_factor, %(gcf)r):
            y, aux = jax.jit(lambda pp, xx, cf=cf: moe_alltoall_apply(
                pp, xx, num_experts=own.moe_experts, top_k=own.moe_top_k,
                capacity_factor=cf, activation=own.activation))(
                    params["layers"][0]["moe"], gx)
            out[f"granite/moe/y/{cf}"] = np.asarray(y)
            out[f"granite/moe/aux/{cf}"] = np.asarray(aux)
    np.savez(sys.argv[2], **out)
""")
NAMES = ("experts_up", "experts_gate", "experts_down")


def _skewed(rng, d):
    """Granite-smoke-wide tokens sharing one direction, so that the router
    sends many of them to the same experts and slots drop at cf 1.25."""
    x = rng.standard_normal((GRANITE["batch"], GRANITE["seq"], d))
    return (x + 2.0 * rng.standard_normal(d)).astype(np.float32)


def _inputs():
    """The expert params (the reference's ``moe_init``), masks keeping
    about 60 % of the 16x16 tiles, x, and granite smoke's tokens and
    first-MoE-layer input.  Returns (numpy arrays for the reference, the
    JAX params and masks, for ``_torch_side``)."""
    from repro.models.moe import moe_init as jmoe_init
    p = jmoe_init(jax.random.PRNGKey(0), D, F, E)
    structures = jbuild_structures(p, JBlockingSpec(bk=16, bn=16), min_size=256)
    rng = np.random.default_rng(0)
    sel = (rng.uniform(size=structures.total_structures) < 0.6).astype(np.float32)
    masks = jmasks_from_knapsack(p, structures, sel)
    arrays = {"x": np.random.default_rng(1).standard_normal((8, 16, D))
              .astype(np.float32),
              "tokens": np.random.default_rng(2).integers(
                  0, 256, size=(GRANITE["batch"], GRANITE["seq"])).astype(np.int32),
              "granite_x": _skewed(np.random.default_rng(4), make_smoke(
                  get_config("granite-moe-1b-a400m")).d_model),
              "p/router": np.asarray(p["router"]["kernel"])}
    for n in NAMES:
        arrays[f"p/{n}"] = np.asarray(p[n])
        arrays[f"mask/{n}"] = np.asarray(masks[n])
    return arrays, (p, masks, structures)


def _torch_side(p, masks, structures):
    """The torch trees, dense and packed (through the reference's own
    ``pack_params``), and granite smoke (cfg, bridged params)."""
    packed = jpack_params(p, masks, structures)
    trees = {"dense": params_from_reference(p, "cpu"),
             "packed": params_from_reference(packed, "cpu")}
    assert isinstance(trees["packed"]["experts_up"], BSRPlanes)
    jcfg = jmake_smoke(jget_config("granite-moe-1b-a400m"), moe_impl="alltoall",
                       capacity_factor=GRANITE_CF)
    cfg = make_smoke(get_config("granite-moe-1b-a400m"), moe_impl="alltoall",
                     capacity_factor=GRANITE_CF)
    granite = (cfg, params_from_reference(jinit_params(jax.random.PRNGKey(0), jcfg),
                                          "cpu"))
    return trees, granite


# --- the ranks (module-level: spawned processes import them by name) -----

def _mesh_ranks(rank, mesh_shape, x, trees, extra):
    torch.set_num_threads(1)
    mesh = make_test_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    xs = x.chunk(mesh_shape[0], 0)[mesh.get_local_rank("data")]
    out = {}
    with use_mesh(mesh), axis_rules(make_train_rules(False)):
        assert alltoall_available(E)
        for kind in KINDS:
            for cf in extra.get("cfs", CFS):
                with torch.no_grad():
                    out[(kind, cf)] = moe_alltoall_apply(
                        trees[kind], xs, num_experts=E, top_k=K,
                        capacity_factor=cf)
        if "grad" in extra:
            p = {"router": {"kernel": trees["dense"]["router"]["kernel"].clone()
                            .requires_grad_()},
                 **{n: trees["dense"][n].clone().requires_grad_() for n in NAMES}}
            xg = xs.clone().requires_grad_()
            y, _ = moe_alltoall_apply(p, xg, num_experts=E, top_k=K,
                                      capacity_factor=8.0)
            y.sum().backward()
            out["grad"] = {"x": xg.grad, "router": p["router"]["kernel"].grad,
                           **{n: p[n].grad for n in NAMES}}
        if "granite" in extra:
            cfg, params = extra["granite"]
            toks = extra["tokens"]
            out["remat"] = _remat_grads(cfg, params, toks)
            with torch.no_grad():
                logits, aux = lm_forward(params, {"tokens": toks}, cfg)
                caches = init_caches(cfg, *toks.shape, torch.float32, "cpu")
                plog, _ = lm_prefill(params, caches, {"tokens": toks}, cfg)
            out["granite"] = (logits, aux["moe_aux"], plog)
            own = cfg.replace(capacity_factor=GRANITE_OWN_CF)
            with torch.no_grad():
                logits, _ = lm_forward(params, {"tokens": toks}, own)
                plog, _ = lm_prefill(params, caches, {"tokens": toks}, own)
                moe = {cf: moe_alltoall_apply(
                    params["layers"][0]["moe"], extra["granite_x"],
                    num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                    capacity_factor=cf, activation=cfg.activation)
                    for cf in (GRANITE_OWN_CF, GRANITE_CF)}
            out["granite_own"] = (logits, plog, moe)
    return out


def _remat_grads(cfg, params, toks):
    """Gradients of granite's loss under the installed mesh: without
    remat on this thread, and with each layer recomputed ("full", and
    "dots", which keeps the projections and the router's logits) in a
    backward run on another thread, which does not see this thread's
    mesh and rules (as autograd's device thread does not on the card)."""
    import threading
    from repro_torch.models import cross_entropy_loss
    grads = []
    for remat, thread in (("none", False), ("full", True), ("dots", True)):
        p = {**params, "layers": [
            {**lp, "moe": {**lp["moe"], "experts_up":
                           lp["moe"]["experts_up"].clone().requires_grad_()}}
            for lp in params["layers"]]}
        logits, _ = lm_forward(p, {"tokens": toks}, cfg.replace(remat=remat))
        loss = cross_entropy_loss(logits, toks)
        if thread:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
        else:
            loss.backward()
        grads.append([lp["moe"]["experts_up"].grad for lp in p["layers"]])
    return grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and every rank's: the JAX subprocess runs
    while the port's ranks run, one gloo spawn per mesh, the three at
    once: (1, 1) at cf E/k, (1, 2) with the gradient and granite runs,
    (2, 2)."""
    d = tmp_path_factory.mktemp("moe_a2a")
    arrays, jax_side = _inputs()
    np.savez(d / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = _REF % dict(ekdf=(E, K, D, F), meshes=MESHES, cfs=CFS,
                         gcf=GRANITE_CF)
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(d / "inputs.npz"), str(d / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        trees, granite = _torch_side(*jax_side)
        x = torch.from_numpy(arrays["x"])
        extras = {(1, 1): {"cfs": (E / K,)}, (2, 2): {},
                  (1, 2): {"grad": True, "granite": granite,
                           "tokens": torch.from_numpy(arrays["tokens"]).long(),
                           "granite_x": torch.from_numpy(arrays["granite_x"])}}
        with ThreadPoolExecutor(len(extras)) as pool:
            futures = {shape: pool.submit(
                run_ranks, _mesh_ranks, shape[0] * shape[1], backend="gloo",
                device_type="cpu", init_file=d / f"init_{shape[0]}x{shape[1]}",
                args=(shape, x, trees, extra)) for shape, extra in extras.items()}
            ranks = {shape: f.result() for shape, f in futures.items()}
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    ref = dict(np.load(d / "ref.npz"))
    return dict(ref=ref, ranks=ranks, trees=trees, granite=granite,
                x=arrays["x"], tokens=arrays["tokens"])


def _gathered(outs, mesh_shape, key):
    """The global (y, aux) of a case: each data shard's y, concatenated,
    after checking that every model rank of the shard holds the same y
    (under drops they take model rank 0's, the reference's global y) and
    every rank the same aux."""
    dp, m = mesh_shape
    for di in range(dp):
        y0 = outs[di * m][key][0]
        assert all(torch.equal(outs[di * m + j][key][0], y0) for j in range(m))
    ys = [outs[di * m][key][0] for di in range(dp)]
    auxes = [o[key][1] for o in outs]
    assert all(torch.equal(a, auxes[0]) for a in auxes)
    return torch.cat(ys, 0), auxes[0]


@pytest.mark.parametrize("mesh_shape,kind,cf", CASES,
                         ids=[f"{a}x{b}-{k}-cf{cf}" for (a, b), k, cf in CASES])
def test_moe_alltoall_matches_reference(runs, mesh_shape, kind, cf):
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}/{kind}/{cf}"
    outs = runs["ranks"][mesh_shape]
    y, aux = _gathered(outs, mesh_shape, (kind, cf))
    np.testing.assert_allclose(y.numpy(), runs["ref"][f"y/{tag}"], atol=Y_TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(runs["ref"][f"aux/{tag}"]),
                               atol=AUX_TOL, rtol=0)


def test_capacity_factor_one_drops_slots(runs):
    """At cf 1.0 the reference drops slots (its output differs from cf
    8.0's), so the equality above holds on which slots drop; and the
    port's model ranks still hold one y, model rank 0's."""
    for a, b in MESHES:
        tag = f"{a}x{b}/dense"
        assert np.abs(runs["ref"][f"y/{tag}/1.0"] - runs["ref"][f"y/{tag}/8.0"]
                      ).max() > 1e-3
    outs = runs["ranks"][(1, 2)]
    assert torch.equal(outs[0][("dense", 1.0)][0], outs[1][("dense", 1.0)][0])


@pytest.mark.parametrize("kind", KINDS)
def test_degenerate_mesh_equals_moe_apply(runs, kind):
    """(1, 1) mesh at cf E/k, where neither path drops a slot."""
    got, got_aux = _gathered(runs["ranks"][(1, 1)], (1, 1), (kind, E / K))
    want, want_aux = moe_apply(runs["trees"][kind], torch.from_numpy(runs["x"]),
                               num_experts=E, top_k=K, capacity_factor=E / K)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=Y_TOL, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               atol=AUX_TOL, rtol=0)


def test_gradients_through_the_exchange_equal_moe_apply(runs):
    """(1, 2) mesh, dense, cf 8.0: every rank's grad of sum(y) w.r.t. x
    and the router equals ``moe_apply``'s; each rank's expert grads are
    its own experts' (zero elsewhere), together ``moe_apply``'s."""
    dense = runs["trees"]["dense"]
    p = {"router": {"kernel": dense["router"]["kernel"].clone().requires_grad_()},
         **{n: dense[n].clone().requires_grad_() for n in NAMES}}
    x = torch.from_numpy(runs["x"]).requires_grad_()
    y, _ = moe_apply(p, x, num_experts=E, top_k=K, capacity_factor=8.0)
    y.sum().backward()
    grads = [o["grad"] for o in runs["ranks"][(1, 2)]]
    for g in grads:
        np.testing.assert_allclose(g["x"].numpy(), x.grad.numpy(), atol=Y_TOL, rtol=0)
        np.testing.assert_allclose(g["router"].numpy(),
                                   p["router"]["kernel"].grad.numpy(),
                                   atol=Y_TOL, rtol=0)
    for n in NAMES:
        for r, g in enumerate(grads):
            other = slice(E // 2, E) if r == 0 else slice(0, E // 2)
            assert not g[n][other].any()
        np.testing.assert_allclose((grads[0][n] + grads[1][n]).numpy(),
                                   p[n].grad.numpy(), atol=Y_TOL, rtol=0)


@pytest.mark.parametrize("fn", ["forward", "prefill"])
def test_granite_smoke_under_the_mesh_matches_reference(runs, fn):
    """Logits within 1e-5 of the largest |logit| (fp32 sums in another
    order over 4 layers; the logits reach ~16), on both model ranks."""
    want = runs["ref"][f"granite/{fn}"]
    for out in runs["ranks"][(1, 2)]:
        logits, aux, plog = out["granite"]
        got = (logits if fn == "forward" else plog).numpy()
        assert np.abs(got - want).max() <= Y_TOL * max(1.0, np.abs(want).max())
    if fn == "forward":
        np.testing.assert_allclose(float(aux), float(runs["ref"]["granite/aux"]),
                                   atol=AUX_TOL, rtol=0)


def test_granite_smoke_at_its_own_capacity_factor_keeps_the_replicas_equal(runs):
    """At granite's own cf 1.25 under the (1, 2) mesh slots drop: both
    model ranks give the same logits from lm_forward and lm_prefill, and
    the first MoE layer's y and aux on both ranks equal the reference's
    global ones (its y differs from the cf E/k one, so slots dropped)."""
    ranks = runs["ranks"][(1, 2)]
    (logits0, plog0, _), (logits1, plog1, _) = (o["granite_own"] for o in ranks)
    assert torch.equal(logits0, logits1) and torch.equal(plog0, plog1)
    ref = runs["ref"]
    own, full = f"granite/moe/y/{GRANITE_OWN_CF}", f"granite/moe/y/{GRANITE_CF}"
    assert np.abs(ref[own] - ref[full]).max() > 1e-3
    for out in ranks:
        for cf in (GRANITE_OWN_CF, GRANITE_CF):
            y, aux = out["granite_own"][2][cf]
            np.testing.assert_allclose(y.numpy(), ref[f"granite/moe/y/{cf}"],
                                       atol=Y_TOL, rtol=0)
            np.testing.assert_allclose(float(aux),
                                       float(ref[f"granite/moe/aux/{cf}"]),
                                       atol=AUX_TOL, rtol=0)


def test_remat_backward_on_another_thread_routes_as_the_forward(runs):
    """Each layer's recomputation runs under the forward's mesh and rules,
    so the gradients equal the no-remat pass's (a recomputation through
    ``moe_apply`` would save other tensors and fail, or differ)."""
    for out in runs["ranks"][(1, 2)]:
        plain, *remats = out["remat"]
        assert len(remats) == 2
        for remat in remats:
            for a, b in zip(plain, remat):
                assert b is not None and a.abs().max() > 0
                torch.testing.assert_close(b, a, atol=1e-6, rtol=0)


def test_granite_smoke_without_a_mesh_runs_moe_apply(runs):
    """No mesh installed: ``moe_impl="alltoall"`` runs ``moe_apply``, as
    the reference does; the rules alone do not switch it."""
    cfg, params = runs["granite"]
    toks = {"tokens": torch.from_numpy(runs["tokens"]).long()}
    with torch.no_grad():
        want, _ = lm_forward(params, toks, cfg.replace(moe_impl="gspmd"))
        got, _ = lm_forward(params, toks, cfg)
        with axis_rules(make_train_rules(False)):
            assert not alltoall_available(cfg.moe_experts)
            ruled, _ = lm_forward(params, toks, cfg)
    assert torch.equal(got, want) and torch.equal(ruled, want)


@pytest.mark.parametrize("kind", KINDS)
def test_row_counts_change_nothing(runs, kind):
    """The expert FFN on a buffer whose rows past each expert's fill are
    zero gives the same output with and without the fill as row counts."""
    g = torch.Generator().manual_seed(3)
    counts = torch.tensor([5, 0, 12, 16], dtype=torch.int32)
    ebuf = torch.randn((E, 16, D), generator=g)
    ebuf = ebuf * (torch.arange(16)[None, :, None] < counts[:, None, None])
    with_counts = _expert_ffn(ebuf, runs["trees"][kind], "silu", counts)
    without = _expert_ffn(ebuf, runs["trees"][kind], "silu", None)
    np.testing.assert_allclose(with_counts.numpy(), without.numpy(),
                               atol=1e-6, rtol=0)
    assert with_counts.shape == (E, 16, D)


def test_shard_experts_slices_every_leaf_and_its_metadata(runs):
    dense, packed = runs["trees"]["dense"], runs["trees"]["packed"]
    for rank in range(2):
        lo, hi = rank * E // 2, (rank + 1) * E // 2
        d = shard_experts(dense, rank, 2)
        p = shard_experts(packed, rank, 2)
        assert d["router"] is dense["router"] and p["router"] is packed["router"]
        for n in NAMES:
            assert torch.equal(d[n], dense[n][lo:hi])
            leaf = p[n]
            assert leaf.shape == (2, *packed[n].shape[1:])
            assert leaf.plane_nnz == packed[n].plane_nnz[lo:hi]
            assert leaf.num_planes == 2 and leaf.nnz_blocks == sum(leaf.plane_nnz)
            np.testing.assert_array_equal(
                unpack_params({"w": leaf})["w"].numpy(),
                unpack_params({"w": packed[n]})["w"][lo:hi].numpy())
    assert planes_pspec(dense["experts_up"], "model") == ("model", None, None)
    spec = planes_pspec(packed["experts_up"], "model")
    assert spec["blocks"] == ("model", None, None, None)
    assert spec["flat_rows"] == ("model", None)
    with pytest.raises(ValueError, match="do not split"):
        shard_experts(dense, 0, 3)
