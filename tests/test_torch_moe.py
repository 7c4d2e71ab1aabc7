"""The port's MoE slice against the JAX package, on the CPU.

Same seeded numpy inputs (or JAX-initialised params carried over with
``repro_torch.bridge``) go through the JAX function and its counterpart
in the port:

* the plain planes matmul against ``ref.bsr_planes_matmul_ref`` and the
  Pallas planes kernel in interpret mode (dead plane, ragged K/N, M = 1
  and M > bm, every epilogue): fp32 within 1e-5, bf16 within 1e-2; with
  row counts it equals itself on x with the rows past each count zeroed,
  and the reference on that x;
* ``pack_params`` on 3-D expert leaves gives the reference's
  ``BSRPlanes`` bit for bit, and the bridge carries a ``BSRPlanes`` over
  as a ``BSRPlanes``, not as a ``BSRWeight`` with 3-D maps;
* ``moe_apply`` / ``moe_decode`` (dense and packed experts) within 1e-5,
  aux within 1e-6, at a capacity factor that drops slots and at one that
  drops none; with the dispatch's row counts bit-identical to the same
  call without them, and the counts equal to ``min(bincount, cap)`` of
  the routing per group, computed in numpy;
* the granite smoke model's prefill / decode logits within 1e-4 and its
  greedy tokens equal, dense and knapsack-pruned; the streamed engine
  token-identical to solo decode at a drop-free capacity factor;
* the plain structure norms against the Pallas kernel in interpret mode
  and ``ref.structure_norms_ref``.

fp32 sums differ from the reference's only in order; bf16 results may
differ by one bf16 rounding of those sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import pack_bsr as jpack_bsr
from repro.core.masks import _get_path as jget_path
from repro.core.packing import BSRPlanes as JBSRPlanes
from repro.kernels import Epilogue as JEpilogue
from repro.kernels import ref as jref
from repro.kernels.block_sparse_matmul import bsr_planes_matmul_pallas
from repro.kernels.structure_norms import structure_norms_pallas
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import lm_decode, lm_generate, lm_prefill
from repro.models.moe import moe_apply as jmoe_apply
from repro.models.moe import moe_decode as jmoe_decode
from repro.models.moe import moe_init as jmoe_init
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference, tensor_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.core import BlockingSpec, BSRPlanes, BSRWeight
from repro_torch.core.structures import iter_leaves
from repro_torch.kernels import Epilogue, launch_counts, ops, reset_launch_counts
from repro_torch.kernels.block_sparse_matmul import bsr_planes_matmul_plain, live_rows
from repro_torch.kernels.structure_norms import structure_norms_plain
from repro_torch.launch import serve
from repro_torch.models import init_caches
from repro_torch.models import lm_decode as tlm_decode
from repro_torch.models import lm_generate as tlm_generate
from repro_torch.models import lm_prefill as tlm_prefill
from repro_torch.models import moe as tmoe
from repro_torch.models.moe import moe_apply, moe_decode, router_logits
from repro_torch.serving import ServingEngine
from repro_torch.sparse import knapsack_prune, pack_params, sparsity_summary

TOL = 1e-5
FIELDS = ("indices", "slots", "flat_rows", "flat_cols", "blocks")
_CACHE = {}
jlm_prefill = jax.jit(lm_prefill, static_argnames=("cfg", "start_pos"))
jlm_decode = jax.jit(lm_decode, static_argnames=("cfg",))
jlm_generate = jax.jit(lm_generate, static_argnames=("num_tokens", "cfg"))
_MOE_STATIC = ("num_experts", "top_k", "capacity_factor", "activation")
jmoe_apply = jax.jit(jmoe_apply, static_argnames=_MOE_STATIC + ("groups",))
jmoe_decode = jax.jit(jmoe_decode, static_argnames=_MOE_STATIC)
jplanes_ref = jax.jit(jref.bsr_planes_matmul_ref)
jplanes_pallas = jax.jit(bsr_planes_matmul_pallas,
                         static_argnames=("bm", "interpret"))
jnorms_ref = jax.jit(jref.structure_norms_ref, static_argnums=(1, 2))
jnorms_pallas = jax.jit(structure_norms_pallas,
                        static_argnames=("bk", "bn", "interpret"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke-size ops are far too small for intra-op threads: with one
    per test worker they do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the planes matmul
# ---------------------------------------------------------------------------

# (e, m, k, n, bk, bn, per-plane densities)
PLANE_SHAPES = [
    (3, 16, 128, 96, 32, 32, (0.6, 0.0, 1.0)),   # tests/test_kernels.py:124
    (2, 1, 130, 50, 32, 32, (0.5, 0.0)),         # ragged K/N, M = 1
    (3, 40, 96, 64, 32, 32, (0.3, 1.0, 0.0)),    # M > bm = 16
]
EPI_SPECS = ["bias", "silu+mult", "res", "bias+gelu+mult+res"]
PLANE_CASES = ([(i, "none", "float32") for i in range(3)]
               + [(1, spec, "float32") for spec in EPI_SPECS]
               + [(2, "bias+gelu+mult+res", "float32")]
               + [(i, "silu+mult", "bfloat16") for i in (0, 1)])


def _make_planes(rng, e, k, n, bk, bn, densities, dtype):
    """The reference's fused BSRPlanes of E random masked planes."""
    planes = []
    for d in densities:
        w = rng.normal(size=(k, n)).astype(np.float32)
        ebk, ebn = min(bk, k), min(bn, n)
        alive = rng.uniform(size=(-(-k // ebk), -(-n // ebn))) < d
        mask = np.repeat(np.repeat(alive, ebk, 0), ebn, 1)[:k, :n]
        planes.append(jpack_bsr(jnp.asarray(w).astype(dtype),
                                JBlockingSpec(bk=bk, bn=bn),
                                mask=mask.astype(np.float32)))
    return JBSRPlanes.from_planes(tuple(planes), shape=(e, k, n))


def _epilogues(rng, lead, n, spec, dtype):
    """The same epilogue on both sides: (JAX Epilogue, torch Epilogue)."""
    if spec == "none":
        return None, None
    arrays = {}
    if "bias" in spec:
        arrays["bias"] = rng.normal(size=(n,)).astype(np.float32)
    if "mult" in spec:
        arrays["multiplier"] = rng.normal(size=(*lead, n)).astype(np.float32)
    if "res" in spec:
        arrays["residual"] = rng.normal(size=(*lead, n)).astype(np.float32)
    act = next((a for a in ("gelu", "silu") if a in spec), None)
    jarr = {key: jnp.asarray(v) if key == "bias" else jnp.asarray(v).astype(dtype)
            for key, v in arrays.items()}
    return (JEpilogue(activation=act, **jarr),
            Epilogue(activation=act, **{key: tensor_from_reference(v)
                                        for key, v in jarr.items()}))


@pytest.mark.parametrize("case,spec,dtype", PLANE_CASES)
def test_planes_plain_matches_reference_and_pallas(case, spec, dtype):
    e, m, k, n, bk, bn, dens = PLANE_SHAPES[case]
    jdt = getattr(jnp, dtype)
    rng = np.random.default_rng(PLANE_CASES.index((case, spec, dtype)))
    jplanes = _make_planes(rng, e, k, n, bk, bn, dens, jdt)
    x = jnp.asarray(rng.normal(size=(e, m, k)).astype(np.float32)).astype(jdt)
    je, te = _epilogues(rng, (e, m), n, spec, jdt)
    want = np.asarray(jplanes_ref(x, jplanes, epilogue=je)
                      .astype(jnp.float32))
    pallas = np.asarray(jplanes_pallas(
        x, jplanes, bm=16, epilogue=je, interpret=True).astype(jnp.float32))
    got = bsr_planes_matmul_plain(tensor_from_reference(x),
                                  params_from_reference(jplanes), epilogue=te)
    assert got.dtype == getattr(torch, dtype) and got.shape == (e, m, n)
    tol = TOL if dtype == "float32" else 1e-2
    for other in (want, pallas):
        np.testing.assert_allclose(got.float().numpy(), other, atol=tol, rtol=tol)
    if 0.0 in dens and spec == "none":            # a dead plane gives 0
        assert not got[dens.index(0.0)].any()


def test_planes_ops_dispatch_cpu_takes_plain_version_without_launches():
    rng = np.random.default_rng(41)
    planes = params_from_reference(_make_planes(
        rng, 3, 64, 96, 32, 32, (0.5, 0.0, 1.0), jnp.float32))
    x = torch.from_numpy(rng.normal(size=(3, 2, 5, 64)).astype(np.float32))
    mult = torch.from_numpy(rng.normal(size=(3, 2, 5, 96)).astype(np.float32))
    reset_launch_counts()
    got = ops.bsr_planes_matmul(x, planes, epilogue=Epilogue(
        activation="silu", multiplier=mult))
    want = bsr_planes_matmul_plain(x.reshape(3, 10, 64), planes, epilogue=Epilogue(
        activation="silu", multiplier=mult.reshape(3, 10, 96)))
    assert torch.equal(got, want.reshape(3, 2, 5, 96))
    w = torch.from_numpy(rng.normal(size=(100, 36)).astype(np.float32))
    assert torch.equal(ops.structure_norms(w, 32, 32),
                       structure_norms_plain(w, 32, 32))
    assert all(v == 0 for v in launch_counts.values()), launch_counts


# (segments, C) -> per-plane counts of 0, C and ragged ones, for 3 planes
ROW_COUNTS = {
    "zero": {1: [[0], [0], [0]], 2: [[0, 0], [0, 0], [0, 0]]},
    "full": {1: [[8], [8], [8]], 2: [[8, 8], [8, 8], [8, 8]]},
    "ragged": {1: [[3], [0], [8]], 2: [[1, 8], [0, 5], [8, 0]]},
}


@pytest.mark.parametrize("spec", ["none"] + EPI_SPECS)
@pytest.mark.parametrize("segs", [1, 2])
@pytest.mark.parametrize("kind", sorted(ROW_COUNTS))
def test_planes_plain_row_counts_zero_the_rows_past_the_count(kind, segs, spec):
    """With row counts, the plain planes matmul equals itself on x whose
    rows past each segment's count are zeroed (bit for bit), and the
    reference and the Pallas kernel on that x."""
    e, c, k, n = 3, 8, 96, 64
    m = segs * c
    rng = np.random.default_rng(17 * segs + len(spec))
    jplanes = _make_planes(rng, e, k, n, 32, 32, (0.5, 1.0, 0.3), jnp.float32)
    x = rng.normal(size=(e, m, k)).astype(np.float32)
    counts = torch.tensor(ROW_COUNTS[kind][segs], dtype=torch.int32)
    live = live_rows(counts, m).numpy()
    assert live.shape == (e, m) and live.sum() == int(counts.sum())
    x0 = np.where(live[..., None], x, 0.0).astype(np.float32)
    je, te = _epilogues(rng, (e, m), n, spec, jnp.float32)
    planes = params_from_reference(jplanes)
    got = bsr_planes_matmul_plain(torch.from_numpy(x), planes, epilogue=te,
                                  row_counts=counts)
    assert torch.equal(got, bsr_planes_matmul_plain(torch.from_numpy(x0), planes,
                                                    epilogue=te))
    want = np.asarray(jplanes_ref(jnp.asarray(x0), jplanes, epilogue=je))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # through the ops dispatch, with x shaped (E, segments, C, K)
    reset_launch_counts()
    te4 = None if te is None else te.map_operands(lambda a: a.reshape(e, segs, c, n))
    y = ops.bsr_planes_matmul(torch.from_numpy(x).reshape(e, segs, c, k), planes,
                              epilogue=te4, row_counts=counts)
    assert torch.equal(y.reshape(e, m, n), got)
    assert all(v == 0 for v in launch_counts.values()), launch_counts


# ---------------------------------------------------------------------------
# (b), (c) packing and the bridge
# ---------------------------------------------------------------------------

def _granite_smoke(**over):
    jcfg = jmake_smoke(jget_config("granite-moe-1b-a400m"), **over)
    cfg = make_smoke(get_config("granite-moe-1b-a400m"), **over)
    assert (cfg.moe_experts, cfg.moe_top_k, cfg.kv_heads) == (4, 2, 4)
    return jcfg, cfg


def _models():
    """(jax cfg, torch cfg, {kind: (jax params, torch params)})."""
    if "models" not in _CACHE:
        jcfg, cfg = _granite_smoke(n_layers=2)
        jdense = jinit_params(jax.random.PRNGKey(0), jcfg)
        tdense = params_from_reference(jdense)
        kw = dict(sparsity=0.5, min_size=1024)
        jsel = jknapsack_prune(jdense, blocking=JBlockingSpec(32, 32), **kw)
        tsel = knapsack_prune(tdense, blocking=BlockingSpec(32, 32), **kw)
        np.testing.assert_array_equal(tsel.result.x, jsel.result.x)
        _CACHE["models"] = (jcfg, cfg, {
            "dense": (jdense, tdense),
            "packed": (jpack_params(jdense, jsel.masks, jsel.structures),
                       pack_params(tdense, tsel.masks, tsel.structures)),
        })
    return _CACHE["models"]


def _assert_same_planes(tp, jp, where=""):
    assert isinstance(tp, BSRPlanes), where
    assert tp.shape == tuple(jp.shape) and tp.plane_nnz == tuple(jp.plane_nnz)
    assert (tp.blocking.bk, tp.blocking.bn) == (jp.blocking.bk, jp.blocking.bn)
    for f in FIELDS:
        got, want = getattr(tp, f), tensor_from_reference(getattr(jp, f))
        assert got.dtype == want.dtype and torch.equal(got, want), (where, f)


@pytest.mark.parametrize("sparsity", [0.5, 0.75])
def test_pack_params_planes_identical_to_reference(sparsity):
    jparams, tparams = _models()[2]["dense"]
    kw = dict(sparsity=sparsity, min_size=1024)
    jsel = jknapsack_prune(jparams, blocking=JBlockingSpec(32, 32), **kw)
    tsel = knapsack_prune(tparams, blocking=BlockingSpec(32, 32), **kw)
    np.testing.assert_array_equal(tsel.result.x, jsel.result.x)
    jpacked = jpack_params(jparams, jsel.masks, jsel.structures)
    tpacked = pack_params(tparams, tsel.masks, tsel.structures)
    n_planes = 0
    for path, leaf in iter_leaves(tpacked):
        if isinstance(leaf, BSRPlanes):
            _assert_same_planes(leaf, jget_path(jpacked, path), path)
            # the store pads with grid_n - 1 (a dead plane keeps pack_bsr's
            # one zero block at column 0), so every plane stays sorted
            fc = leaf.flat_cols.numpy()
            assert (np.diff(fc, axis=1) >= 0).all()
            for e, z in enumerate(leaf.plane_nnz):
                assert (fc[e, max(z, 1):] == leaf.grid_n - 1).all()
            n_planes += 1
    assert n_planes == 2 * 3                      # 2 layers x up/gate/down
    summ = sparsity_summary(tpacked)
    assert summ["nnz_blocks"] == tsel.kept and summ["total_blocks"] == tsel.total


def test_bridge_keeps_planes_and_weights_apart():
    rng = np.random.default_rng(7)
    jplanes = _make_planes(rng, 3, 96, 64, 32, 32, (0.5, 0.0, 1.0), jnp.float32)
    jweight = jpack_bsr(rng.normal(size=(96, 64)).astype(np.float32),
                        JBlockingSpec(32, 32))
    tree = params_from_reference({"experts_up": jplanes, "wq": {"kernel": jweight}})
    assert isinstance(tree["experts_up"], BSRPlanes)
    _assert_same_planes(tree["experts_up"], jplanes)
    assert tree["experts_up"].indices.ndim == 3
    assert [p.nnz_blocks for p in tree["experts_up"].planes] == list(jplanes.plane_nnz)
    w = tree["wq"]["kernel"]
    assert isinstance(w, BSRWeight) and not isinstance(w, BSRPlanes)
    assert w.indices.ndim == 2 and w.nnz_blocks == jweight.nnz_blocks


# ---------------------------------------------------------------------------
# (d) moe_apply / moe_decode
# ---------------------------------------------------------------------------

def _moe_params(kind):
    if kind not in _CACHE:
        jp = jmoe_init(jax.random.PRNGKey(3), 128, 128, 4, gated=True)
        if kind == "packed":
            sel = jknapsack_prune({"moe": jp}, sparsity=0.5,
                                  blocking=JBlockingSpec(32, 32), min_size=1024)
            jp = jpack_params({"moe": jp}, sel.masks, sel.structures)["moe"]
            assert isinstance(jp["experts_up"], JBSRPlanes)
        _CACHE[kind] = (jp, params_from_reference(jp))
    return _CACHE[kind]


def _max_expert_load(tp, x, groups):
    """Most slots any expert is asked for in any routing group."""
    b, s, d = x.shape
    g = np.gcd(groups or b, b * s)
    logits = router_logits(torch.from_numpy(x).reshape(g, -1, d),
                           tp["router"]["kernel"])
    top = torch.topk(logits, 2, dim=-1).indices.reshape(g, -1)
    return max(int(torch.bincount(row, minlength=4).max()) for row in top)


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_moe_apply_and_decode_match_reference(kind, cf):
    jp, tp = _moe_params(kind)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 24, 128)).astype(np.float32)
    kw = dict(num_experts=4, top_k=2, capacity_factor=cf)
    want, jaux = jmoe_apply(jp, jnp.asarray(x), **kw)
    got, aux = moe_apply(tp, torch.from_numpy(x), **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    cap = int(np.ceil(24 * 2 * cf / 4))
    assert (_max_expert_load(tp, x, None) > cap) == (cf == 1.25)  # drops

    xd = rng.normal(size=(5, 1, 128)).astype(np.float32)
    want, jaux = jmoe_decode(jp, jnp.asarray(xd), num_experts=4, top_k=2)
    got, aux = moe_decode(tp, torch.from_numpy(xd), num_experts=4, top_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_moe_row_counts_bit_identical_and_match_reference(monkeypatch, kind, cf):
    """The dispatch's row counts change nothing: moe_apply and moe_decode
    give the same bits with them and without them (the expert matmuls
    handed no counts), and the JAX reference's output within 1e-5, at a
    capacity factor that drops slots (1.25) and at one that drops none
    (4.0 = E/k for the decode's 2 of 4)."""
    jp, tp = _moe_params(kind)
    rng = np.random.default_rng(int(cf * 8))
    x = torch.from_numpy(rng.normal(size=(2, 24, 128)).astype(np.float32))
    xd = torch.from_numpy(rng.normal(size=(5, 1, 128)).astype(np.float32))
    kw = dict(num_experts=4, top_k=2, capacity_factor=cf)
    got, aux = moe_apply(tp, x, **kw)
    got_d = moe_decode(tp, xd, **kw)[0]
    want, _ = jmoe_apply(jp, jnp.asarray(x.numpy()), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    want, _ = jmoe_decode(jp, jnp.asarray(xd.numpy()), **kw)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    monkeypatch.setattr(tmoe, "expert_row_counts", lambda *a: None)
    plain, aux0 = moe_apply(tp, x, **kw)
    assert torch.equal(got, plain) and torch.equal(aux, aux0)
    assert torch.equal(got_d, moe_decode(tp, xd, **kw)[0])


@pytest.mark.parametrize("cf,groups", [(1.25, None), (1.25, 4), (4.0, None)])
def test_expert_row_counts_are_min_of_bincount_and_capacity(monkeypatch, cf, groups):
    """Every expert matmul gets the (g, E) counts min(tokens routed to e
    in group g, cap), computed here in numpy from the routing."""
    _, tp = _moe_params("packed")
    rng = np.random.default_rng(23)
    b, s, d, e_n, k = 2, 24, 128, 4, 2
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    seen = []

    def spy(h, w, **kw):
        seen.append(kw.get("row_counts"))
        return expert_matmul(h, w, **kw)

    expert_matmul = tmoe.expert_matmul
    monkeypatch.setattr(tmoe, "expert_matmul", spy)
    moe_apply(tp, torch.from_numpy(x), num_experts=e_n, top_k=k,
              capacity_factor=cf, groups=groups)
    g = np.gcd(groups or b, b * s)
    n = b * s // g
    cap = max(int(np.ceil(n * k * cf / e_n)), k)
    logits = router_logits(torch.from_numpy(x).reshape(g, n, d),
                           tp["router"]["kernel"]).numpy()
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :k].reshape(g, -1)
    want = np.stack([np.minimum(np.bincount(t, minlength=e_n), cap) for t in top])
    assert len(seen) == 3                              # up, gate, down
    for counts in seen:
        assert counts.dtype == torch.int32 and counts.shape == (g, e_n)
        np.testing.assert_array_equal(counts.numpy(), want)
    if (cf, groups) == (1.25, 4):                 # a case where slots drop
        assert (want < np.stack([np.bincount(t, minlength=e_n) for t in top])).any()


# ---------------------------------------------------------------------------
# (e), (f) the granite smoke model and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_granite_prefill_decode_generate_match_reference(kind):
    jcfg, cfg, params = _models()
    jp, tp = params[kind]
    rng = np.random.default_rng(5)
    b, s, gen = 2, 11, 5
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    jc = jinit_caches(jcfg, b, s + gen, jnp.float32)
    tc = init_caches(cfg, b, s + gen, torch.float32, device="cpu")
    jl, jc = jlm_prefill(jp, jc, {"tokens": jnp.asarray(tokens)}, cfg=jcfg)
    tl, tc = tlm_prefill(tp, tc, {"tokens": torch.from_numpy(tokens)}, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)

    step = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
    clen = np.array([s, s - 3], np.int32)
    jd, _ = jlm_decode(jp, [dict(c) for c in jc], {"tokens": jnp.asarray(step)},
                       jnp.asarray(clen), cfg=jcfg)
    td, _ = tlm_decode(tp, [{k: v.clone() for k, v in c.items()} for c in tc],
                       {"tokens": torch.from_numpy(step)},
                       torch.from_numpy(clen), cfg)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4, rtol=1e-4)

    first = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    assert np.array_equal(first, tl[:, -1].argmax(-1)[:, None].numpy())
    jt, _ = jlm_generate(jp, jc, jnp.asarray(first), jnp.asarray(s, jnp.int32),
                         num_tokens=gen, cfg=jcfg)
    tt, _ = tlm_generate(tp, tc, torch.from_numpy(first), s, gen, cfg)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_granite_engine_streams_match_solo_decode():
    """Pruned at 32x32, a shared 2-page prefix (request 1 repeats request
    0), at capacity_factor E/k = 2 for the smoke's 4 experts top-2 (here
    4.0 as on the card): no slot can drop, so a prefix-hit tail prefill
    routes like the solo decode's whole prompt."""
    _, cfg, params = _models()
    cfg = cfg.replace(capacity_factor=4.0)
    tp = params["packed"][1]
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, cfg.vocab, size=8)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, size=n)])
               .astype(np.int32) for n in (3, 5, 1, 6)]
    prompts[1] = prompts[0].copy()
    eng = ServingEngine(tp, cfg, num_slots=2, page_size=4, max_seq_len=24,
                        ticks_per_sync=4, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, 6, arrival=i)
    done = eng.run()
    assert eng.prefix_stats["hit_requests"] >= 1
    assert all(len(r.tokens) == 6 for r in done.values())
    assert serve.verify_streams(tp, cfg, done, 6, device="cpu") == []


def test_serve_granite_stream_smoke_exits_zero(capsys):
    assert serve.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
                       "--smoke", "--stream", "--pruned", "0.75", "--block",
                       "32,32", "--min-size", "1024", "--requests", "4",
                       "--gen", "4", "--shared-prefix"]) == 0
    assert "verify OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (g) structure norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kshape", [(64, 64), (128, 384), (100, 36), (8, 1024)])
@pytest.mark.parametrize("blocks", [(32, 32), (64, 128), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_structure_norms_plain_matches_reference(kshape, blocks, dtype):
    k, n = kshape
    bk, bn = blocks
    rng = np.random.default_rng(k * n)
    w = jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)).astype(
        getattr(jnp, dtype))
    got = structure_norms_plain(tensor_from_reference(w), bk, bn)
    assert got.dtype == torch.float32
    for want in (jnorms_pallas(w, bk=bk, bn=bn, interpret=True),
                 jnorms_ref(w, bk, bn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
