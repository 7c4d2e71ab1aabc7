"""Plain versions of the port's Hopper kernels against the JAX package's
references, on the CPU.

Same seeded numpy inputs go to ``repro.kernels.ref.bsr_matmul_ref`` /
``paged_attention_*_ref`` and to the port's ``*_plain`` functions; fp32
results agree within 1e-5 (absolute and relative): both sides accumulate
in fp32 and differ only in summation order.  The BSR weight is packed on
the JAX side and carried over with ``repro_torch.bridge``.  The ops
dispatch is checked to take the plain version for CPU tensors without a
single kernel launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockingSpec as JBlockingSpec
from repro.core import pack_bsr as jpack_bsr
from repro.kernels import Epilogue as JEpilogue
from repro.kernels import ref as jref
from repro.kernels.paged_attention import (
    paged_attention_decode_ref,
    paged_attention_prefill_ref,
)
from repro_torch.bridge import params_from_reference
from repro_torch.kernels import Epilogue, launch_counts, ops, reset_launch_counts
from repro_torch.kernels.block_sparse_matmul import (
    BSR_MAX_GROUP_SLOTS,
    BSR_MAX_GROUPS,
    BSR_STRIPE,
    H100_SMS,
    bsr_grid,
    bsr_matmul_plain,
    bsr_planes_grid,
    bsr_slot_groups,
)
from repro_torch.kernels.epilogue import ACTIVATIONS, apply_epilogue
from repro_torch.kernels.paged_attention import (
    DECODE_RANKS,
    PREFILL_ROWS,
    decode_chunk,
    decode_grid,
    paged_attention_decode_plain,
    paged_attention_prefill_plain,
    prefill_grid,
)

TOL = 1e-5

# (m, k, n, bk, bn, density) — the shapes of tests/test_kernels.py
SHAPES = [
    (64, 256, 128, 128, 128, 0.5),
    (128, 512, 256, 128, 128, 0.25),
    (32, 128, 384, 64, 128, 1.0),
    (8, 130, 50, 32, 32, 0.6),       # ragged tails
    (16, 64, 64, 64, 64, 0.0),       # fully pruned
    (256, 384, 512, 128, 256, 0.4),
    (1, 512, 256, 128, 128, 0.25),   # decode-shaped single row
]
EPI_SPECS = ["bias", "gelu", "bias+silu+mult", "bias+gelu+mult+res"]
# every shape without an epilogue, every epilogue on the ragged and the
# decode-shaped single-row case
CASES = ([(shape, "none") for shape in SHAPES]
         + [(SHAPES[i], spec) for i in (3, 6) for spec in EPI_SPECS])


def _make_bsr(rng, k, n, bk, bn, density, dtype=jnp.float32):
    w = rng.normal(size=(k, n)).astype(np.float32)
    ebk, ebn = min(bk, k), min(bn, n)
    gk, gn = -(-k // ebk), -(-n // ebn)
    alive = rng.uniform(size=(gk, gn)) < density
    mask = np.repeat(np.repeat(alive, ebk, 0), ebn, 1)[:k, :n].astype(np.float32)
    return jpack_bsr(jnp.asarray(w).astype(dtype), JBlockingSpec(bk=bk, bn=bn),
                     mask=mask)


def _epilogues(rng, m, n, spec):
    """The same epilogue on both sides: (JAX Epilogue, torch Epilogue)."""
    if spec == "none":
        return None, None
    ops_np = {}
    if "bias" in spec:
        ops_np["bias"] = rng.normal(size=(n,)).astype(np.float32)
    if "mult" in spec:
        ops_np["multiplier"] = rng.normal(size=(m, n)).astype(np.float32)
    if "res" in spec:
        ops_np["residual"] = rng.normal(size=(m, n)).astype(np.float32)
    act = next((a for a in ("gelu", "silu") if a in spec), None)
    je = JEpilogue(activation=act, **{k: jnp.asarray(v) for k, v in ops_np.items()})
    te = Epilogue(activation=act, **{k: torch.from_numpy(v) for k, v in ops_np.items()})
    return je, te


@pytest.mark.parametrize("shape,spec", CASES)
def test_bsr_plain_matches_reference(shape, spec):
    m, k, n, bk, bn, density = shape
    rng = np.random.default_rng(CASES.index((shape, spec)))
    jbsr = _make_bsr(rng, k, n, bk, bn, density)
    x = rng.normal(size=(m, k)).astype(np.float32)
    je, te = _epilogues(rng, m, n, spec)
    want = np.asarray(jref.bsr_matmul_ref(jnp.asarray(x), jbsr, epilogue=je))
    got = bsr_matmul_plain(torch.from_numpy(x), params_from_reference(jbsr),
                           epilogue=te)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SHAPES[3:5] + SHAPES[6:])
def test_bsr_plain_bf16_matches_reference(shape):
    """bf16 operands: the same fp32 sums, rounded to bf16 at the end —
    equal up to one bf16 rounding step of the (slightly different) fp32
    sums."""
    m, k, n, bk, bn, density = shape
    rng = np.random.default_rng(5)
    jbsr = _make_bsr(rng, k, n, bk, bn, density, jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32)).astype(jnp.bfloat16)
    want = np.asarray(jref.bsr_matmul_ref(x, jbsr).astype(jnp.float32))
    tbsr = params_from_reference(jbsr)
    assert tbsr.blocks.dtype == torch.bfloat16
    got = bsr_matmul_plain(params_from_reference(x), tbsr)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_epilogue_activation_names_follow_jax():
    """``gelu`` is jax.nn.gelu's tanh approximation, not torch's exact
    default; every named activation matches jax.nn on the same input."""
    import jax

    y = np.linspace(-6, 6, 101).astype(np.float32)
    for name, fn in ACTIVATIONS.items():
        np.testing.assert_allclose(fn(torch.from_numpy(y)).numpy(),
                                   np.asarray(getattr(jax.nn, name)(y)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    epi = Epilogue(bias=torch.ones(3), activation="gelu",
                   multiplier=torch.full((2, 3), 2.0), residual=torch.ones(2, 3))
    yt = torch.zeros(2, 3)
    want = torch.nn.functional.gelu(yt + 1, approximate="tanh") * 2.0 + 1.0
    assert torch.equal(apply_epilogue(yt, epi), want)
    with pytest.raises(ValueError):
        Epilogue(activation="swish")


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------

def _pools(rng, b, kvh, dh, ps, max_pages, lens, poison):
    """Shuffled non-null page ids per row (rows of length 0 park on the
    null page); with ``poison`` every slot no row owns is NaN."""
    n_pages = b * max_pages + 1
    lens = np.asarray(lens)
    ids = rng.permutation(np.arange(1, n_pages))[: b * max_pages]
    tbl = np.where(lens[:, None] == 0, 0, ids.reshape(b, max_pages)).astype(np.int32)
    if poison:
        kp = np.full((n_pages, ps, kvh, dh), np.nan, np.float32)
        vp = np.full((n_pages, ps, kvh, dh), np.nan, np.float32)
        for r in range(b):
            for t in range(int(lens[r])):
                kp[tbl[r, t // ps], t % ps] = rng.normal(size=(kvh, dh))
                vp[tbl[r, t // ps], t % ps] = rng.normal(size=(kvh, dh))
    else:
        kp = rng.normal(size=(n_pages, ps, kvh, dh)).astype(np.float32)
        vp = rng.normal(size=(n_pages, ps, kvh, dh)).astype(np.float32)
    return kp, vp, tbl


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("ps", [4, 8, 16])
def test_paged_decode_plain_matches_reference(ps, h, kvh):
    """Ragged cache_len including 0 (a row parked on the null page) and
    NaN in every pool slot no row owns, the null page included."""
    rng = np.random.default_rng(ps * 10 + h + kvh)
    b, dh, max_pages = 4, 32, 5
    clen = np.array([0, 3, ps * 2 + 1, max_pages * ps - 1], np.int32)
    kp, vp, tbl = _pools(rng, b, kvh, dh, ps, max_pages, clen, poison=True)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kn = rng.normal(size=(b, kvh, dh)).astype(np.float32)
    vn = rng.normal(size=(b, kvh, dh)).astype(np.float32)
    want = np.asarray(paged_attention_decode_ref(
        *(jnp.asarray(a) for a in (q, kn, vn, kp, vp, tbl, clen))))
    got = paged_attention_decode_plain(*_t(q, kn, vn, kp, vp, tbl, clen))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("q_offset", [0, "3ps"])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("ps", [4, 8, 16])
def test_paged_prefill_plain_matches_reference(ps, h, kvh, q_offset):
    """Causal page walk with ragged totals (one row past its length mid
    tail), the q_offset tail of a prefix hit, and NaN in every slot no
    row owns."""
    off = {0: 0, "3ps": 3 * ps}[q_offset]
    rng = np.random.default_rng(ps * 100 + h * 10 + kvh + off)
    b, s, dh = 3, 21, 16
    total = off + s
    lens = np.array([total, max(off + 5, 1), total - 2], np.int32)
    max_pages = -(-total // ps) + 1
    kp, vp, tbl = _pools(rng, b, kvh, dh, ps, max_pages, lens, poison=True)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    want = np.asarray(paged_attention_prefill_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, tbl, lens)), q_offset=off))
    got = paged_attention_prefill_plain(*_t(q, kp, vp, tbl, lens), q_offset=off)
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # rows at or past their row's length are exactly zero
    for r in range(b):
        dead = max(int(lens[r]) - off, 0)
        assert not got[r, dead:].any()


def test_ops_dispatch_cpu_takes_plain_version_without_launches():
    rng = np.random.default_rng(31)
    reset_launch_counts()
    jbsr = _make_bsr(rng, 96, 80, 32, 32, 0.5)
    bsr = params_from_reference(jbsr)
    x = torch.from_numpy(rng.normal(size=(2, 3, 96)).astype(np.float32))
    mult = torch.from_numpy(rng.normal(size=(2, 3, 80)).astype(np.float32))
    epi = Epilogue(activation="silu", multiplier=mult)
    got = ops.bsr_matmul(x, bsr, epilogue=epi)
    want = bsr_matmul_plain(x.reshape(6, 96), bsr, epilogue=Epilogue(
        activation="silu", multiplier=mult.reshape(6, 80))).reshape(2, 3, 80)
    assert torch.equal(got, want)

    b, h, kvh, dh, ps, mp = 2, 4, 2, 8, 4, 3
    clen = np.array([5, 0], np.int32)
    kp, vp, tbl = _pools(rng, b, kvh, dh, ps, mp, clen, poison=True)
    q, kn, vn = (rng.normal(size=s).astype(np.float32)
                 for s in ((b, h, dh), (b, kvh, dh), (b, kvh, dh)))
    args = _t(q, kn, vn, kp, vp, tbl, clen)
    assert torch.equal(ops.paged_attention_decode(*args),
                       paged_attention_decode_plain(*args))
    lens = np.array([7, 6], np.int32)
    kp, vp, tbl = _pools(rng, b, kvh, dh, ps, mp, lens, poison=True)
    qp = rng.normal(size=(b, 3, h, dh)).astype(np.float32)
    pargs = _t(qp, kp, vp, tbl, lens)
    assert torch.equal(ops.paged_attention_prefill(*pargs, q_offset=4),
                       paged_attention_prefill_plain(*pargs, q_offset=4))
    assert all(v == 0 for v in launch_counts.values()), launch_counts


# (grid_n, max_nnz, bn): qwen's 1024- and 2816-wide projections at 128x128
# tiles, granite's 512-wide k/v, a dense 32x32 column, a column near the
# slot cap of one group, one slot, and a layout wider than the card
GROUP_LAYOUTS = [(8, 8, 128), (22, 2, 128), (8, 3, 128), (4, 8, 128),
                 (32, 88, 32), (2, 1000, 32), (8, 1, 128), (300, 5, 128),
                 (1, 5000, 128)]


@pytest.mark.parametrize("grid_n,max_nnz,bn", GROUP_LAYOUTS)
def test_bsr_slot_groups_partition(grid_n, max_nnz, bn):
    """Every slot falls in exactly one group; at most one cluster of
    groups, each within the kernel's shared-memory slot list; a decode
    call fills the card where the slots allow it."""
    per, groups = bsr_slot_groups(grid_n, max_nnz, bn)
    owner = [s // per for s in range(max_nnz)]
    assert sorted(set(owner)) == list(range(groups))      # none empty
    assert 1 <= groups <= BSR_MAX_GROUPS and 1 <= per <= BSR_MAX_GROUP_SLOTS
    assert per * groups >= max_nnz > per * (groups - 1)
    ctas = grid_n * -(-bn // BSR_STRIPE) * groups
    assert ctas >= H100_SMS or groups == min(max_nnz, BSR_MAX_GROUPS)


def test_bsr_grid_does_not_change_with_m():
    """The slot groups and the column grid are the weight's: only the row
    tiles follow M (so a row's summation order does not)."""
    rng = np.random.default_rng(41)
    bsr = params_from_reference(_make_bsr(rng, 1024, 2816, 128, 128, 0.1))
    for dtype in (torch.float32, torch.bfloat16):
        geo = {m: bsr_grid(m, bsr, dtype) for m in (1, 4, 8, 47, 200, 512)}
        for m, (grid, per, bm) in geo.items():
            assert grid[:2] == geo[1][0][:2] and per == geo[1][1]
            assert grid[2] == -(-m // bm) and bm in (4, 8, 16, 64)
        assert geo[4][0][0] * geo[4][0][1] >= H100_SMS or geo[4][0][1] == bsr.max_nnz


@pytest.mark.parametrize("h,kvh", [(16, 16), (16, 8)])
def test_prefill_grid_at_main_path_prompts(h, kvh):
    """qwen's (16/16) and granite's (16/8) heads at a 47-token prompt:
    at least 48 CTAs, one per 16 query rows of a KV head."""
    grid = prefill_grid(1, 47, h, kvh)
    assert grid[1] == kvh and grid[0] * grid[1] * grid[2] >= 48
    assert grid[2] * PREFILL_ROWS >= 47 * (h // kvh) > (grid[2] - 1) * PREFILL_ROWS


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("ps", [4, 8, 16, 3, 64])
def test_decode_chunk_and_grid_follow_ps_dh_and_the_table_only(ps, dh):
    """The decode kernel's chunk is a multiple of the page size fixed by
    (ps, dh) alone (a row's chunks, and their virtual ranks c % 8, then
    follow from its own length); the grid's cluster size follows the
    table width and never B or the lengths (no host sync); the main
    paths' 10-page tables take 3 CTAs per (row, KV head)."""
    chunk = decode_chunk(ps, dh)
    assert chunk % ps == 0 and chunk >= 32 and chunk // ps <= 32
    for width in (1, 3, 10, 64, 400):
        ranks = {decode_grid(b, 8, ps, dh, width) for b in (1, 4, 5)}
        assert ranks == {(min(DECODE_RANKS, -(-width * ps // chunk)), 8, b)
                         for b in (1, 4, 5)}
    assert decode_grid(4, 16, 8, 64, 10) == (3, 16, 4)
    with pytest.raises(ValueError):
        decode_chunk(ps, 96)


def test_planes_grid_is_fixed_by_the_layout():
    """The planes kernel's slot groups come from the stack's layout (E,
    grid_n, max_nnz, bn), never from M, the segments or the counts; the
    row tile follows the segment length C; grid.z is E x segments x row
    tiles of a segment."""
    rng = np.random.default_rng(5)
    from repro_torch.core import BSRPlanes
    planes = BSRPlanes.from_planes(tuple(
        params_from_reference(_make_bsr(rng, 1024, 512, 128, 128, d))
        for d in (0.2, 0.0, 1.0, 0.5)), shape=(4, 1024, 512))
    for dtype, tiles in ((torch.float32, {8: 8, 15: 16, 47: 16, 200: 64}),
                         (torch.bfloat16, {8: 16, 15: 16, 47: 16, 200: 64})):
        geo = {(c, segs): bsr_planes_grid(c * segs, segs, planes, dtype)
               for c in tiles for segs in (1, 2)}
        for (c, segs), (grid, per, bm) in geo.items():
            assert grid[:2] == geo[(8, 1)][0][:2] and per == geo[(8, 1)][1]
            assert bm == tiles[c] and grid[2] == 4 * segs * -(-c // bm)
    per, groups = bsr_slot_groups(4, 8, 128, planes=32)     # granite's up/gate
    assert (per, groups) == (8, 1)
