"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels are built with nvcc and run only on an
NVIDIA card (sm_90a), so these tests skip where there is none.  Run them
on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``; ``chip_smoke.py`` runs the same comparisons
at the main path's shapes.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import BlockingSpec, BSRPlanes, pack_bsr
from repro_torch.kernels import Epilogue, launch_counts, ops, reset_launch_counts
from repro_torch.kernels.block_sparse_matmul import (
    bsr_matmul_plain,
    bsr_planes_matmul_plain,
)
from repro_torch.kernels.structure_norms import structure_norms_plain
from repro_torch.kernels.paged_attention import (
    paged_attention_decode_plain,
    paged_attention_prefill_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m", [1, 4, 64, 200])
def test_bsr_kernel_matches_plain(card, m, dtype, tol):
    g = torch.Generator(device=card).manual_seed(m)
    k, n, bk, bn = 300, 200, 64, 64
    w = torch.randn((k, n), generator=g, device=card).to(dtype)
    alive = torch.rand((5, 4), generator=g, device=card) < 0.5
    alive[:, 0] = False                                     # all-pruned column
    mask = alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1)[:k, :n]
    bsr = pack_bsr(w, BlockingSpec(bk, bn), mask=mask)
    x = torch.randn((m, k), generator=g, device=card).to(dtype)
    epi = Epilogue(bias=torch.randn(n, generator=g, device=card).to(dtype),
                   activation="silu",
                   multiplier=torch.randn((m, n), generator=g, device=card).to(dtype),
                   residual=torch.randn((m, n), generator=g, device=card).to(dtype))
    reset_launch_counts()
    got = ops.bsr_matmul(x, bsr, epilogue=epi)
    torch.cuda.synchronize()
    assert launch_counts["bsr_matmul"] == 1
    assert _rel_err(got, bsr_matmul_plain(x, bsr, epilogue=epi)) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m", [1, 8, 47])
def test_bsr_planes_kernel_matches_plain(card, m, dtype, tol):
    """Three planes, one dead and one fully dense, ragged K/N, the
    silu * up epilogue with a shared bias: one launch for the stack."""
    g = torch.Generator(device=card).manual_seed(100 + m)
    e, k, n, bk, bn = 3, 300, 200, 64, 64
    planes = []
    for density in (0.5, 0.0, 1.0):
        w = torch.randn((k, n), generator=g, device=card).to(dtype)
        alive = torch.rand((5, 4), generator=g, device=card) < density
        mask = alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1)[:k, :n]
        planes.append(pack_bsr(w, BlockingSpec(bk, bn), mask=mask))
    stack = BSRPlanes.from_planes(tuple(planes), shape=(e, k, n))
    x = torch.randn((e, m, k), generator=g, device=card).to(dtype)
    epi = Epilogue(bias=torch.randn(n, generator=g, device=card),
                   activation="silu",
                   multiplier=torch.randn((e, m, n), generator=g, device=card).to(dtype))
    reset_launch_counts()
    got = ops.bsr_planes_matmul(x, stack, epilogue=epi)
    torch.cuda.synchronize()
    assert launch_counts["bsr_planes_matmul"] == 1
    want = bsr_planes_matmul_plain(x, stack, epilogue=epi)
    assert _rel_err(got, want) <= tol
    dead = torch.nn.functional.silu(epi.bias)[None] * epi.multiplier[1].float()
    assert _rel_err(got[1], dead) <= tol          # dead plane: epilogue(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kshape,blocks", [((1024, 2816), (128, 128)),
                                           ((100, 36), (32, 32))])
def test_structure_norms_kernel_matches_plain(card, kshape, blocks, dtype):
    g = torch.Generator(device=card).manual_seed(kshape[0])
    w = torch.randn(kshape, generator=g, device=card).to(dtype)
    reset_launch_counts()
    got = ops.structure_norms(w, *blocks)
    torch.cuda.synchronize()
    assert launch_counts["structure_norms"] == 1
    assert _rel_err(got, structure_norms_plain(w, *blocks)) <= 1e-5


@pytest.mark.parametrize("q_offset", [0, 8])
def test_paged_kernels_match_plain(card, q_offset):
    g = torch.Generator(device=card).manual_seed(q_offset)
    b, h, kvh, dh, ps, mp = 3, 8, 2, 64, 8, 6
    pool = torch.full((b * mp + 1, ps, kvh, dh), math.nan, device=card)
    kp, vp = pool.clone(), pool.clone()
    tbl = torch.randperm(b * mp, generator=g, device=card).reshape(b, mp) + 1
    clen = torch.tensor([0, 11, 40], dtype=torch.int32, device=card)
    tbl[0] = 0                                             # parked on null page
    for r in range(b):
        for t in range(int(clen[r])):
            kp[tbl[r, t // ps], t % ps] = torch.randn((kvh, dh), generator=g, device=card)
            vp[tbl[r, t // ps], t % ps] = torch.randn((kvh, dh), generator=g, device=card)
    tbl = tbl.to(torch.int32)
    q = torch.randn((b, h, dh), generator=g, device=card)
    kn = torch.randn((b, kvh, dh), generator=g, device=card)
    vn = torch.randn((b, kvh, dh), generator=g, device=card)
    got = ops.paged_attention_decode(q, kn, vn, kp, vp, tbl, clen)
    want = paged_attention_decode_plain(q, kn, vn, kp, vp, tbl, clen)
    assert torch.isfinite(got).all() and _rel_err(got, want) <= 2e-5
    s = 40 - q_offset
    lens = torch.tensor([0, 11, 40], dtype=torch.int32, device=card).clamp(min=0)
    qp = torch.randn((b, s, h, dh), generator=g, device=card)
    got = ops.paged_attention_prefill(qp, kp, vp, tbl, lens, q_offset=q_offset)
    want = paged_attention_prefill_plain(qp, kp, vp, tbl, lens, q_offset=q_offset)
    assert torch.isfinite(got).all() and _rel_err(got, want) <= 2e-5
    np.testing.assert_array_equal(got[0].cpu().numpy(), 0.0)


def _layout(card, g, k, n, bk, bn, dense_col=None, p_live=0.3, dtype=torch.float32):
    """A random BSR weight: tiles live with probability ``p_live``, block
    column ``dense_col`` fully live."""
    w = torch.randn((k, n), generator=g, device=card).to(dtype)
    gk, gn = -(-k // bk), -(-n // bn)
    alive = torch.rand((gk, gn), generator=g, device=card) < p_live
    if dense_col is not None:
        alive[:, dense_col] = True
    mask = alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1)[:k, :n]
    return pack_bsr(w, BlockingSpec(bk, bn), mask=mask)


# (K, N, bk, bn, dense column, live share): qwen's down projection at
# 32x32 tiles with one dense column (88 live slots, several slot groups),
# a column near the slot cap of one group (1000 live slots), and a
# 128x128 decode layout
INVARIANCE_LAYOUTS = {
    "down_32x32_dense_column": (2816, 1024, 32, 32, 5, 0.25),
    "near_cap": (32000, 64, 32, 32, 1, 0.02),
    "qkv_128x128": (1024, 1024, 128, 128, None, 0.3),
}


@pytest.mark.parametrize("layout", sorted(INVARIANCE_LAYOUTS))
def test_bsr_rows_bit_identical_across_m(card, layout):
    """fp32: a row's output is the same bit for bit alone (M 1) and
    inside M 4, 47 and 200 (the stream == solo decode gate needs it)."""
    k, n, bk, bn, dense, p_live = INVARIANCE_LAYOUTS[layout]
    g = torch.Generator(device=card).manual_seed(k + n)
    bsr = _layout(card, g, k, n, bk, bn, dense, p_live)
    x = torch.randn((200, k), generator=g, device=card)
    mult = torch.randn((200, n), generator=g, device=card)
    bias = torch.randn(n, generator=g, device=card)

    def run(rows):
        epi = Epilogue(bias=bias, activation="silu", multiplier=mult[rows])
        return ops.bsr_matmul(x[rows], bsr, epilogue=epi)

    full = run(slice(0, 200))
    assert _rel_err(full, bsr_matmul_plain(
        x, bsr, epilogue=Epilogue(bias=bias, activation="silu",
                                  multiplier=mult))) <= 1e-5
    for m in (4, 47):
        assert torch.equal(run(slice(0, m)), full[:m]), f"M {m}"
    for r in (0, 3, 46, 199):
        assert torch.equal(run(slice(r, r + 1)), full[r:r + 1]), f"row {r}"


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m", [1, 4, 47, 200])
def test_bsr_kernel_dense_and_near_cap_columns(card, m, dtype, tol):
    g = torch.Generator(device=card).manual_seed(300 + m)
    for k, n, bk, bn, dense, p_live in (INVARIANCE_LAYOUTS["down_32x32_dense_column"],
                                        INVARIANCE_LAYOUTS["near_cap"]):
        bsr = _layout(card, g, k, n, bk, bn, dense, p_live, dtype)
        x = torch.randn((m, k), generator=g, device=card).to(dtype)
        res = torch.randn((m, n), generator=g, device=card).to(dtype)
        epi = Epilogue(residual=res)
        got = ops.bsr_matmul(x, bsr, epilogue=epi)
        assert _rel_err(got, bsr_matmul_plain(x, bsr, epilogue=epi)) <= tol


def _prefill_pools(card, g, lens, kvh, dh, ps, max_pages):
    """Pools holding each row's K/V at its pages (shuffled), NaN in every
    slot no row owns."""
    b = len(lens)
    tbl = (torch.randperm(b * max_pages, generator=g, device=card)
           .reshape(b, max_pages) + 1)
    kp = torch.full((b * max_pages + 1, ps, kvh, dh), math.nan, device=card)
    vp = kp.clone()
    for r, ln in enumerate(lens):
        t = torch.arange(ln, device=card)
        kp[tbl[r, t // ps], t % ps] = torch.randn((ln, kvh, dh), generator=g, device=card)
        vp[tbl[r, t // ps], t % ps] = torch.randn((ln, kvh, dh), generator=g, device=card)
    return kp, vp, tbl.to(torch.int32)


@pytest.mark.parametrize("h,kvh", [(16, 16), (16, 8)])
def test_prefill_rows_bit_identical_across_calls(card, h, kvh):
    """fp32: a query position's output is the same bit for bit in a full
    prefill (q_offset 0, S = L), a tail prefill (q_offset 3 ps) and a
    ragged batch of 3 rows."""
    g = torch.Generator(device=card).manual_seed(h + kvh)
    dh, ps, L = 64, 8, 75
    lens = [L + 9, L, 11]                       # the row under test is 1
    kp, vp, tbl = _prefill_pools(card, g, lens, kvh, dh, ps, -(-(L + 9) // ps))
    q = torch.randn((3, L + 9, h, dh), generator=g, device=card)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=card)
    one = torch.tensor([L], dtype=torch.int32, device=card)
    full = ops.paged_attention_prefill(q[1:2, :L].contiguous(), kp, vp,
                                       tbl[1:2].contiguous(), one)
    want = paged_attention_prefill_plain(q[1:2, :L], kp, vp, tbl[1:2], one)
    assert _rel_err(full, want) <= 2e-5
    off = 3 * ps
    tail = ops.paged_attention_prefill(q[1:2, off:L].contiguous(), kp, vp,
                                       tbl[1:2].contiguous(), one, q_offset=off)
    assert torch.equal(tail, full[:, off:])
    batch = ops.paged_attention_prefill(q, kp, vp, tbl, lens_t)
    assert torch.equal(batch[1, :L], full[0])
    assert bool((batch[1, L:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_head_dim_128(card, dtype):
    g = torch.Generator(device=card).manual_seed(128)
    lens = [70, 33]
    kp, vp, tbl = _prefill_pools(card, g, lens, 2, 128, 16, 5)
    kp, vp = kp.to(dtype), vp.to(dtype)
    q = torch.randn((2, 70, 8, 128), generator=g, device=card).to(dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=card)
    got = ops.paged_attention_prefill(q, kp, vp, tbl, lens_t)
    want = paged_attention_prefill_plain(q, kp, vp, tbl, lens_t)
    assert torch.isfinite(got).all() and _rel_err(got, want) <= 2e-5


def _planes(card, g, e, k, n, bk, bn, dtype, dead=()):
    """A BSRPlanes stack of E random planes about 40 % live; planes in
    ``dead`` have no live tile."""
    planes = []
    for p in range(e):
        w = torch.randn((k, n), generator=g, device=card).to(dtype)
        alive = torch.rand((-(-k // bk), -(-n // bn)), generator=g,
                           device=card) < (0.0 if p in dead else 0.4)
        mask = alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1)[:k, :n]
        planes.append(pack_bsr(w, BlockingSpec(bk, bn), mask=mask))
    return BSRPlanes.from_planes(tuple(planes), shape=(e, k, n))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("segs,c", [(1, 8), (1, 47), (2, 15)])
def test_bsr_planes_row_counts_match_plain(card, segs, c, dtype, tol):
    """Counts of 0, C and ragged ones, one or two segments per plane, a
    plane with live tiles whose counts are all 0: the kernel with counts
    matches the plain version with counts, and every row past its count
    is epilogue(0) (here silu(bias) * mult + res)."""
    g = torch.Generator(device=card).manual_seed(17 * segs + c)
    e, k, n = 4, 1024, 512
    stack = _planes(card, g, e, k, n, 128, 128, dtype, dead=(3,))
    m = segs * c
    counts = torch.tensor([[0, c], [c, 1], [c // 2, 0], [3, c]][:e],
                          dtype=torch.int32, device=card)[:, :segs].contiguous()
    x = torch.randn((e, m, k), generator=g, device=card).to(dtype)
    epi = Epilogue(bias=torch.randn(n, generator=g, device=card),
                   activation="silu",
                   multiplier=torch.randn((e, m, n), generator=g, device=card).to(dtype),
                   residual=torch.randn((e, m, n), generator=g, device=card).to(dtype))
    reset_launch_counts()
    got = ops.bsr_planes_matmul(x, stack, epilogue=epi, row_counts=counts)
    torch.cuda.synchronize()
    assert launch_counts["bsr_planes_matmul"] == 1
    want = bsr_planes_matmul_plain(x, stack, epilogue=epi, row_counts=counts)
    assert _rel_err(got, want) <= tol
    zero = (torch.nn.functional.silu(epi.bias)[None, None] * epi.multiplier.float()
            + epi.residual.float())
    live = torch.arange(c, device=card)[None, None] < counts[..., None]
    dead = ~live.reshape(e, m)
    assert _rel_err(got[dead], zero[dead]) <= tol


@pytest.mark.parametrize("k,n", [(1024, 512), (512, 1024)])
def test_bsr_planes_rows_bit_identical(card, k, n):
    """fp32: a row of plane e is the same bit for bit at M 1, 8 and 47,
    and with and without counts for rows below the count."""
    g = torch.Generator(device=card).manual_seed(k)
    e = 8
    stack = _planes(card, g, e, k, n, 128, 128, torch.float32)
    x = torch.randn((e, 47, k), generator=g, device=card)
    mult = torch.randn((e, 47, n), generator=g, device=card)

    def run(m, counts=None):
        return ops.bsr_planes_matmul(
            x[:, :m].contiguous(), stack, row_counts=counts,
            epilogue=Epilogue(activation="silu", multiplier=mult[:, :m].contiguous()))

    full = run(47)
    for m in (1, 8):
        assert torch.equal(run(m), full[:, :m]), f"M {m}"
    counts = torch.tensor([[c] for c in (47, 0, 5, 16, 17, 1, 33, 46)],
                          dtype=torch.int32, device=card)
    with_counts = run(47, counts)
    for p in range(e):
        c = int(counts[p])
        assert torch.equal(with_counts[p, :c], full[p, :c]), f"plane {p}"


def _decode_case(card, g, lens, h, kvh, dh, ps, max_pages, pool_dtype=torch.float32):
    """q, k_new, v_new, NaN-poisoned pools and shuffled tables for rows of
    cached lengths ``lens``."""
    b = len(lens)
    kp, vp, tbl = _prefill_pools(card, g, lens, kvh, dh, ps, max_pages)
    for r, ln in enumerate(lens):
        if ln == 0:
            tbl[r] = 0                                  # parked on the null page
    q = torch.randn((b, h, dh), generator=g, device=card)
    kn = torch.randn((b, kvh, dh), generator=g, device=card)
    vn = torch.randn((b, kvh, dh), generator=g, device=card)
    clen = torch.tensor(lens, dtype=torch.int32, device=card)
    return q, kn, vn, kp.to(pool_dtype), vp.to(pool_dtype), tbl, clen


@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("h,kvh", [(16, 16), (16, 8), (8, 2), (4, 1)])
def test_paged_decode_chunks_match_plain(card, ps, h, kvh):
    """Lengths 0, 1, a chunk boundary (32), two chunks, more than 8 chunks
    (1500), NaN in every slot no row owns; all four dtype pairs."""
    from repro_torch.kernels.paged_attention import decode_chunk
    chunk = decode_chunk(ps, 64)
    lens = [0, 1, chunk, 2 * chunk, 1500]
    g = torch.Generator(device=card).manual_seed(ps * 100 + h + kvh)
    case = _decode_case(card, g, lens, h, kvh, 64, ps, -(-1500 // ps) + 1)
    for qd in (torch.float32, torch.bfloat16):
        for pd in (torch.float32, torch.bfloat16):
            q, kn, vn = (t.to(qd) for t in case[:3])
            kp, vp = case[3].to(pd), case[4].to(pd)
            reset_launch_counts()
            got = ops.paged_attention_decode(q, kn, vn, kp, vp, *case[5:])
            torch.cuda.synchronize()
            assert launch_counts["paged_attention_decode"] == 1
            want = paged_attention_decode_plain(q, kn, vn, kp, vp, *case[5:])
            assert torch.isfinite(got).all() and _rel_err(got, want) <= 2e-5, (qd, pd)


@pytest.mark.parametrize("ps", [8, 16])
def test_paged_decode_row_bit_identical(card, ps):
    """fp32: a decode row's output is the same bit for bit alone, inside a
    ragged batch of 5 and with a wider page table."""
    g = torch.Generator(device=card).manual_seed(ps)
    lens = [61, 0, 1500, 7, 300]
    mp = -(-1500 // ps) + 1
    q, kn, vn, kp, vp, tbl, clen = _decode_case(card, g, lens, 16, 8, 64, ps, mp)
    batch = ops.paged_attention_decode(q, kn, vn, kp, vp, tbl, clen)
    for r in (0, 2, 4):
        one = [t[r:r + 1].contiguous() for t in (q, kn, vn)]
        need = -(-lens[r] // ps)
        alone = ops.paged_attention_decode(*one, kp, vp, tbl[r:r + 1, :max(need, 1)]
                                           .contiguous(), clen[r:r + 1])
        wide = torch.zeros((1, 4 * mp), dtype=torch.int32, device=card)
        wide[0, :mp] = tbl[r]
        wider = ops.paged_attention_decode(*one, kp, vp, wide, clen[r:r + 1])
        assert torch.equal(alone, batch[r:r + 1]), f"row {r} alone"
        assert torch.equal(wider, batch[r:r + 1]), f"row {r} wide table"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_head_dim_128(card, dtype):
    g = torch.Generator(device=card).manual_seed(129)
    lens = [70, 0, 400]
    q, kn, vn, kp, vp, tbl, clen = _decode_case(card, g, lens, 8, 2, 128, 16, 26)
    q, kn, vn, kp, vp = (t.to(dtype) for t in (q, kn, vn, kp, vp))
    got = ops.paged_attention_decode(q, kn, vn, kp, vp, tbl, clen)
    want = paged_attention_decode_plain(q, kn, vn, kp, vp, tbl, clen)
    assert torch.isfinite(got).all() and _rel_err(got, want) <= 2e-5


# ---------------------------------------------------------------------------
# the serving engine's decode chunk as CUDA graphs
# ---------------------------------------------------------------------------

def _smoke_engine_pair(card, arch, *, sampled, adaptive):
    """Serve the same traffic through an eager and a graphed engine at
    smoke size (2 layers, head_dim 64 as the paged kernels take, knapsack
    0.5 at 32x32, fp32; granite at capacity factor 4.0; the final norm
    scaled by 0.02 so that sampling chooses).  Returns {mode: (engine, [requests by rid per pass],
    launches per pass)}; each engine serves the traffic twice."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.launch import serve
    from repro_torch.serving import AdaptiveChunkPolicy, ServingEngine
    cfg = make_smoke(get_config(arch), n_layers=2, head_dim=64,
                     capacity_factor=4.0)
    params, _ = serve.build_params(cfg, seed=0, device=card, pruned=0.5,
                                   block=(32, 32), min_size=1024)
    params["final_norm"] = {"scale": params["final_norm"]["scale"] * 0.02}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 12, size=5)]
    out = {}
    for graphed in (False, True):
        eng = ServingEngine(
            params, cfg, num_slots=3, page_size=4, max_seq_len=24,
            ticks_per_sync=8 if adaptive else 4,
            chunk_policy=AdaptiveChunkPolicy((1, 2, 4, 8)) if adaptive else None,
            device=card, cuda_graphs=graphed)
        passes, launches = [], []
        for _ in range(2):
            first, base = eng._next_rid, eng.tick
            for i, p in enumerate(prompts):
                kw = dict(temperature=0.8, top_k=20, top_p=0.9) if (
                    sampled and i % 2) else {}
                eng.submit(p, 6, arrival=base + 2 * i, priority=i % 2, **kw)
            reset_launch_counts()
            done = eng.run()
            torch.cuda.synchronize()
            launches.append(dict(launch_counts))
            passes.append({r: q for r, q in done.items() if r >= first})
        out["graphed" if graphed else "eager"] = (eng, passes, launches, params,
                                                  cfg)
    return out


@pytest.mark.parametrize("arch,sampled,adaptive", [
    ("qwen1.5-0.5b", False, False), ("qwen1.5-0.5b", True, True),
    ("granite-moe-1b-a400m", False, False), ("granite-moe-1b-a400m", True, False)])
def test_graphed_streams_equal_eager_and_solo(card, arch, sampled, adaptive):
    from repro_torch.launch import serve
    res = _smoke_engine_pair(card, arch, sampled=sampled, adaptive=adaptive)
    eng, passes, launches, params, cfg = res["graphed"]
    _, epasses, elaunches, _, _ = res["eager"]
    for got, want in zip(passes, epasses):
        assert {r: q.tokens.tolist() for r, q in got.items()} == \
            {r: q.tokens.tolist() for r, q in want.items()}
    # replays count the launches recorded at capture: the same as eager
    assert launches == elaunches
    assert launches[1]["paged_attention_decode"] > 0
    for done in passes:
        assert not serve.verify_streams(params, cfg, done, 6, device=card,
                                        engine=eng)
    an = eng.analysis_stats()
    levels = (1, 2, 4, 8) if adaptive else (4,)
    assert an["cuda_graphs"] == 1
    assert an["captures"] <= 2 * len(levels)
    assert set(an["variants"]) <= {f"{t}/{s}" for t in levels
                                   for s in ("greedy", "sampled")}
    assert sum(an["replays"].values()) > 0


def test_graphs_capture_nothing_new_in_steady_state(card):
    res = _smoke_engine_pair(card, "qwen1.5-0.5b", sampled=True, adaptive=True)
    eng, passes, _, _, _ = res["graphed"]
    before = eng.analysis_stats()
    first = eng._next_rid
    for rid in sorted(passes[0]):
        req = eng.requests[rid]
        eng.submit(req.prompt, req.max_new, arrival=eng.tick + 2 * (rid % 5),
                   priority=req.priority, temperature=req.temperature,
                   top_k=req.top_k, top_p=req.top_p)
    eng.run()
    after = eng.analysis_stats()
    assert after["variants"] == before["variants"]
    assert sum(after["replays"].values()) > sum(before["replays"].values())
    assert after["sync_regions"]["decode_chunk"] - \
        before["sync_regions"]["decode_chunk"] == \
        sum(after["replays"].values()) - sum(before["replays"].values())
    assert eng._next_rid > first


def test_replays_run_without_a_host_sync(card):
    """A replay runs under sync-debug "error": a hidden sync would raise
    (GraphFailure); one that does not is what the engine counts on."""
    from repro_torch.serving import GraphFailure, PackedGraphs
    from repro_torch.serving.engine import _chunk_label
    x = torch.zeros(4, device=card)

    def fn(packed, ticks, sampled):
        return packed + ticks

    g = PackedGraphs(fn, 8, card, region="decode_chunk", label=_chunk_label)
    assert (g(np.arange(8, dtype=np.int32), 3, False) == np.arange(8) + 3).all()
    assert (g(np.arange(8, dtype=np.int32), 3, False) == np.arange(8) + 3).all()
    assert g.stats()["replays"] == {"3/greedy": 1}

    def syncing(packed, ticks, sampled):
        return packed + int(x.sum())        # a host read inside the chunk

    with pytest.raises(GraphFailure):
        PackedGraphs(syncing, 8, card, region="decode_chunk",
                     label=_chunk_label)(np.zeros(8, np.int32), 1, False)


def _smoke_training(device, steps=2):
    """Two ``make_train_step`` steps of the qwen smoke model from the
    same CPU-made params and batches, on ``device``."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.masks import map_tree
    from repro_torch.data import TokenTask
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step
    cfg = make_smoke(get_config("qwen1.5-0.5b"), remat="dots")
    params = map_tree(lambda t: t.to(device), init_params(cfg, seed=0, device="cpu"))
    step = make_train_step(cfg, AdamWConfig(), warmup_cosine(1e-3, 1, 4))
    state = init_train_state(params, AdamWConfig())
    losses = []
    for s in range(steps):
        batch = {k: v.to(device) for k, v in TokenTask(cfg.vocab).batch(s, 4, 16).items()}
        state, m = step(state, batch)
        losses.append([float(m[k]) for k in ("total_loss", "loss")])
    return np.array(losses)


def test_train_step_on_card_matches_cpu(card):
    """The card's step (cuBLAS fp32 matmuls, TF32 off, atomics in the
    embedding backward) against the CPU's: the 2-step losses within
    1e-4 (Adam's first update is ~sign(g), so params are not compared
    element-wise)."""
    got, want = _smoke_training(card), _smoke_training("cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_packed_lm_forward_on_card_matches_masked_dense(card):
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core import apply_masks
    from repro_torch.models import init_params, lm_forward
    from repro_torch.sparse import knapsack_prune, pack_params
    cfg = make_smoke(get_config("qwen1.5-0.5b"))
    params = init_params(cfg, seed=0, device=card)
    sel = knapsack_prune(params, sparsity=0.5, blocking=BlockingSpec(32, 32),
                         min_size=1024)
    packed = pack_params(params, sel.masks, sel.structures)
    tokens = torch.randint(0, cfg.vocab, (4, 16), device=card,
                           generator=torch.Generator(device=card).manual_seed(0))
    reset_launch_counts()
    with torch.no_grad():
        got, _ = lm_forward(packed, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        assert launch_counts["bsr_matmul"] == 7 * cfg.n_layers
        want, _ = lm_forward(apply_masks(params, sel.masks), {"tokens": tokens}, cfg)
    assert _rel_err(got, want) <= 1e-5


# the paper experiments' packed FC layouts: (K, N, bk, bn), tiles (RF, 1)
# and (RF * C, 1), bk 27 over K 96 padded to 4 tiles, LeNet's (50, 1),
# (24, 1) and (1, 1), and the quickstart's (8, 8)
PAPER_LAYOUTS = (
    [(k, n, bk, bn) for k, n in ((16, 64), (64, 32), (32, 32))
     for bk, bn in ((2, 1), (4, 1), (8, 1), (16, 1), (8, 8))]
    + [(96, 42, 27, 1), (96, 42, 3, 1), (42, 64, 9, 1), (400, 120, 50, 1),
       (120, 84, 24, 1), (84, 10, 1, 1)])


def _paper_bsr(card, g, k, n, bk, bn):
    """~40 % of the tiles live, block column 0 all pruned."""
    w = torch.randn((k, n), generator=g, device=card)
    alive = torch.rand((-(-k // bk), -(-n // bn)), generator=g, device=card) < 0.4
    alive[:, 0] = False
    alive[0, -1] = True
    mask = alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1)[:k, :n]
    return pack_bsr(w, BlockingSpec(bk, bn), mask=mask)


@pytest.mark.parametrize("k,n,bk,bn", PAPER_LAYOUTS)
def test_bsr_kernel_paper_layouts(card, k, n, bk, bn):
    """fp32 at M 1/64/256/2048 with the bias epilogue the paper models
    use (and relu + residual on one M): within 1e-5 of the plain
    version, one launch per call, and a row bit-identical alone and
    inside every M."""
    g = torch.Generator(device=card).manual_seed(k * 1000 + n + bk)
    bsr = _paper_bsr(card, g, k, n, bk, bn)
    x = torch.randn((2048, k), generator=g, device=card)
    bias = torch.randn(n, generator=g, device=card)
    res = torch.randn((256, n), generator=g, device=card)
    alone = ops.bsr_matmul(x[:1], bsr, epilogue=Epilogue(bias=bias))
    for m in (1, 64, 256, 2048):
        epi = Epilogue(bias=bias)
        reset_launch_counts()
        got = ops.bsr_matmul(x[:m], bsr, epilogue=epi)
        torch.cuda.synchronize()
        assert launch_counts["bsr_matmul"] == 1
        assert _rel_err(got, bsr_matmul_plain(x[:m], bsr, epilogue=epi)) <= 1e-5
        assert torch.equal(got[:1], alone), f"M {m}"
    epi = Epilogue(bias=bias, activation="relu", residual=res)
    assert _rel_err(ops.bsr_matmul(x[:256], bsr, epilogue=epi),
                    bsr_matmul_plain(x[:256], bsr, epilogue=epi)) <= 1e-5


def test_packed_jets_forward_on_card(card):
    """The jets MLP with fc_1..fc_3 packed at (4, 1) tiles (fc_4, 160
    weights, stays dense): exactly 3 BSR launches per forward, logits
    within 1e-5 of the masked dense forward."""
    from repro_torch.core import apply_masks, build_structures, masks_from_knapsack
    from repro_torch.models.cnn import init_jets_mlp, jets_mlp_forward
    params = init_jets_mlp(generator=torch.Generator(device=card).manual_seed(0),
                           device=card)
    st = build_structures(params, BlockingSpec(4, 1), min_size=256)
    sel = (np.random.default_rng(0).uniform(size=st.total_structures) < 0.4
           ).astype(np.float32)
    masks = masks_from_knapsack(params, st, sel)
    packed = dict(params)
    for info in st.infos:
        layer = info.path.split("/")[0]
        packed[layer] = {**params[layer], "kernel": pack_bsr(
            params[layer]["kernel"], info.blocking, mask=masks[layer]["kernel"])}
    x = torch.randn((2048, 16), generator=torch.Generator(device=card).manual_seed(1),
                    device=card)
    reset_launch_counts()
    with torch.no_grad():
        got = jets_mlp_forward(packed, x)
        torch.cuda.synchronize()
        assert launch_counts["bsr_matmul"] == 3
        want = jets_mlp_forward(apply_masks(params, masks), x)
    assert _rel_err(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the recurrent and hybrid stacks served on the card
# ---------------------------------------------------------------------------

def _recurrent_streams(card, arch, heads, graphed):
    """The 8-layer smoke model (jamba: ``heads`` = (head_dim, heads, KV
    heads), one of the two head dims the paged kernels are built for (64,
    and jamba's own 128 at its 4:1 grouping), capacity factor E/k = 2.0,
    knapsack 0.5 at 32x32 so its attention, MLP and MoE weights run the
    BSR and planes kernels; xLSTM dense), the tied embedding scaled by the
    chip smoke's ``EMBED_SCALE`` so that streams follow the recurrent
    state; one pass of 5 requests.  Returns (requests by rid, launches,
    params, cfg, engine)."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine
    from chip_smoke import EMBED_SCALE
    jamba = arch.startswith("jamba")
    kw = {}
    if jamba:
        dh, h, kvh = heads
        kw = dict(head_dim=dh, n_heads=h, kv_heads=kvh, capacity_factor=2.0)
    cfg = make_smoke(get_config(arch), n_layers=8, **kw)
    params, _ = serve.build_params(cfg, seed=0, device=card,
                                   pruned=0.5 if jamba else None,
                                   block=(32, 32), min_size=1024)
    params["embed"]["embedding"].mul_(EMBED_SCALE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 12, size=5)]
    eng = ServingEngine(params, cfg, num_slots=3, page_size=4, max_seq_len=24,
                        ticks_per_sync=4, device=card, cuda_graphs=graphed)
    for i, p in enumerate(prompts):
        eng.submit(p, 6, arrival=2 * i)
    reset_launch_counts()
    done = eng.run()
    torch.cuda.synchronize()
    return done, dict(launch_counts), params, cfg, eng


@pytest.mark.parametrize("arch,heads", [("jamba-v0.1-52b", (64, 4, 4)),
                                        ("jamba-v0.1-52b", (128, 8, 2)),
                                        ("xlstm-350m", None)])
def test_recurrent_stack_graphed_equals_eager_and_solo_on_card(card, arch, heads):
    """Graphed streams equal the eager ones and solo decode, with the same
    launch counts (jamba: every kernel of its path ran; xLSTM: none);
    the card's prefill logits within 1e-4 of the CPU's plain path."""
    from repro_torch.core.masks import map_tree
    from repro_torch.launch import serve
    from repro_torch.models import init_caches, lm_prefill
    from repro_torch.serving import RequestStatus
    from repro_torch.sparse import unpack_params
    from chip_smoke import distinct_enough
    eager, e_launch, params, cfg, _ = _recurrent_streams(card, arch, heads, False)
    graphed, g_launch, _, _, eng = _recurrent_streams(card, arch, heads, True)
    assert {r: q.tokens.tolist() for r, q in graphed.items()} == \
        {r: q.tokens.tolist() for r, q in eager.items()}
    assert all(q.status is RequestStatus.FINISHED for q in graphed.values())
    assert all(distinct_enough(q.tokens.tolist()) for q in graphed.values())
    assert g_launch == e_launch
    used = ("bsr_matmul", "bsr_planes_matmul", "paged_attention_decode",
            "paged_attention_prefill")
    if arch.startswith("jamba"):
        assert all(g_launch.get(k, 0) > 0 for k in used)
        assert g_launch["paged_attention_decode"] == eng.decode_ticks
    else:
        assert not any(g_launch.get(k, 0) for k in used)
    assert eng.analysis_stats()["captures"] >= 1
    assert not serve.verify_streams(params, cfg, graphed, 6, device=card)
    toks = torch.as_tensor(graphed[0].prompt[None], device=card)
    dense = unpack_params(params) if arch.startswith("jamba") else params
    with torch.no_grad():
        got, _ = lm_prefill(params, init_caches(cfg, 1, 16, device=card),
                            {"tokens": toks}, cfg)
        want, _ = lm_prefill(map_tree(lambda t: t.cpu(), dense),
                             init_caches(cfg, 1, 16, device="cpu"),
                             {"tokens": toks.cpu()}, cfg)
    assert _rel_err(got.cpu(), want) <= 1e-4


def test_capture_survives_a_dead_engine_graph_in_a_cycle(card):
    """An owner of captured graphs in a reference cycle (as an engine is,
    through its bound chunk function) that becomes garbage while another
    chunk is being captured must not be freed there: freeing a CUDAGraph
    during a capture invalidates the capture.  The chunk below drops the
    old owner mid-capture and allocates with the collector set to run on
    nearly every allocation."""
    import gc
    from repro_torch.serving import PackedGraphs
    from repro_torch.serving.engine import _chunk_label
    victims = []

    def fn(packed, ticks, sampled):
        if torch.cuda.is_current_stream_capturing():
            victims.clear()                        # the old owner is garbage now
        junk = [{"i": i} for i in range(200)]
        return packed + ticks + 0 * len(junk)

    class Owner:
        pass

    old = Owner()
    old.me = old
    old.graphs = PackedGraphs(fn, 8, card, region="decode_chunk",
                              label=_chunk_label)
    assert (old.graphs(np.arange(8, dtype=np.int32), 1, False) == np.arange(8) + 1).all()
    victims.append(old)
    del old
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        g = PackedGraphs(fn, 8, card, region="decode_chunk", label=_chunk_label)
        for _ in range(2):
            assert (g(np.arange(8, dtype=np.int32), 2, False) == np.arange(8) + 2).all()
    finally:
        gc.set_threshold(*thresholds)
    assert not victims and g.stats()["replays"] == {"2/greedy": 1}


# ---------------------------------------------------------------------------
# the encoder-decoder and multimodal families on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 300])
def test_bsr_kernel_mixed_dtypes_match_plain(card, m):
    """fp32 weights under bf16 activations (whisper-tiny's config): the
    wrapper contracts in fp32, as the plain version and the reference's
    promoting ``jnp.dot`` do, and returns bf16 within one bf16 rounding."""
    g = torch.Generator(device=card).manual_seed(21)
    bsr = _layout(card, g, 384, 1536, 128, 128, p_live=0.25, dtype=torch.float32)
    x = torch.randn((m, 384), generator=g, device=card).to(torch.bfloat16)
    res = torch.randn((m, 1536), generator=g, device=card).to(torch.bfloat16)
    for epi in (Epilogue(activation="gelu"), Epilogue(residual=res)):
        reset_launch_counts()
        got = ops.bsr_matmul(x, bsr, epilogue=epi)
        assert launch_counts["bsr_matmul"] == 1
        want = bsr_matmul_plain(x, bsr, epilogue=epi)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert _rel_err(got, want) <= 1e-2


def test_whisper_smoke_on_card_matches_cpu(card):
    """whisper smoke, knapsack 0.5 at 32x32 (its encoder and decoder
    attention and MLP weights run the BSR kernel, the gelu epilogue
    alone on w_up; the cross projections stay dense): the card's forward
    with frames within 1e-4 of the masked dense params' on the CPU, lm_prefill +
    lm_generate equal to per-token lm_decode, and one BSR launch per
    packed weight per pass."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.masks import map_tree
    from repro_torch.launch import serve
    from repro_torch.models import (encode_kv_caches, encoder_forward, init_caches,
                                    lm_decode, lm_forward, lm_generate, lm_prefill)
    from repro_torch.sparse import unpack_params
    from chip_smoke import packed_counts
    cfg = make_smoke(get_config("whisper-tiny"))
    params, _ = serve.build_params(cfg, seed=0, device=card, pruned=0.5,
                                   block=(32, 32), min_size=1024)
    prompt, frames = serve.static_inputs(cfg, batch=3, prompt_len=7, seed=0,
                                         device=card)
    n_enc = packed_counts(params["encoder"])[0]
    n_dec = packed_counts(params["layers"])[0]
    with torch.no_grad():
        reset_launch_counts()
        got, _ = lm_forward(params, {"tokens": prompt, "frames": frames}, cfg)
        torch.cuda.synchronize()
        assert launch_counts["bsr_matmul"] == n_enc + n_dec
        cpu = map_tree(lambda t: t.cpu(), unpack_params(params))   # masked dense
        want, _ = lm_forward(cpu, {"tokens": prompt.cpu(), "frames": frames.cpu()}, cfg)
        assert _rel_err(got.cpu(), want) <= 1e-4
        caches = encode_kv_caches(params, encoder_forward(params, frames, cfg), cfg,
                                  init_caches(cfg, 3, 7 + 6, device=card))
        logits, caches = lm_prefill(params, caches, {"tokens": prompt}, cfg)
        assert _rel_err(logits, got) <= 1e-5
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        snap = [{k: v.clone() for k, v in c.items()} for c in caches]
        toks, _ = lm_generate(params, caches, tok, 7, 6, cfg)
        for i in range(6):
            assert torch.equal(tok[:, 0], toks[:, i])
            step, snap = lm_decode(params, snap, {"tokens": tok}, 7 + i, cfg)
            tok = step[:, -1].argmax(-1).to(torch.int32)[:, None]


def test_vlm_smoke_on_card_at_group_size_six(card):
    """qwen2-vl smoke at head_dim 128 with 12 query and 2 KV heads (the
    paged kernels' G 6, as in qwen2-vl-2b), knapsack 0.5 at 32x32: the
    patch prefill with 3-D positions within 1e-4 of the masked dense
    params' on the CPU,
    and the engine's graphed text streams equal to the eager ones and to
    solo decode, every kernel of the path launched."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.masks import map_tree
    from repro_torch.launch import serve
    from repro_torch.models import init_caches, lm_prefill
    from repro_torch.serving import ServingEngine
    from repro_torch.sparse import unpack_params
    from chip_smoke import EMBED_SCALE, vlm_batch
    cfg = make_smoke(get_config("qwen2-vl-2b"), head_dim=128, n_heads=12, kv_heads=2,
                     mrope_sections=(16, 24, 24))
    params, _ = serve.build_params(cfg, seed=0, device=card, pruned=0.5,
                                   block=(32, 32), min_size=1024)
    params["embed"]["embedding"].mul_(EMBED_SCALE)
    tokens, patches, pos = vlm_batch(cfg, 2, 9, seed=1, grid=(2, 4))
    batch = {"tokens": torch.from_numpy(tokens), "patch_embeds": torch.from_numpy(patches),
             "positions": torch.from_numpy(pos)}
    s = tokens.shape[1]
    with torch.no_grad():
        got, _ = lm_prefill(params, init_caches(cfg, 2, s, device=card),
                            {k: v.to(card) for k, v in batch.items()}, cfg)
        want, _ = lm_prefill(map_tree(lambda t: t.cpu(), unpack_params(params)),
                             init_caches(cfg, 2, s, device="cpu"), batch, cfg)
    assert _rel_err(got.cpu(), want) <= 1e-4
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 14, size=5)]
    streams = {}
    for graphed in (False, True):
        eng = ServingEngine(params, cfg, num_slots=3, page_size=8, max_seq_len=24,
                            ticks_per_sync=4, device=card, cuda_graphs=graphed)
        for i, p in enumerate(prompts):
            eng.submit(p, 6, arrival=2 * i)
        reset_launch_counts()
        done = eng.run()
        torch.cuda.synchronize()
        streams[graphed] = {r: q.tokens.tolist() for r, q in done.items()}
        assert all(launch_counts[k] > 0 for k in (
            "bsr_matmul", "paged_attention_decode", "paged_attention_prefill"))
        assert launch_counts["paged_attention_decode"] == cfg.n_layers * eng.decode_ticks
    assert streams[True] == streams[False]
    assert not serve.verify_streams(params, cfg, done, 6, device=card)
