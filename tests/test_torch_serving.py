"""The port's serving layer against the JAX package, on the CPU.

``PagePool`` / ``Scheduler`` are the reference's numpy modules copied
into the port; a few of ``tests/test_serving_engine.py``'s unit cases
run against the copies.  The port's ``ServingEngine`` must emit the
JAX engine's greedy streams token for token on the same bridged,
knapsack-pruned and BSR-packed params — at ``ticks_per_sync`` 1 and 4,
with and without a shared prompt prefix — and ``launch.serve`` must run
its stream smoke to exit 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import lm_generate as jlm_generate
from repro.models import lm_prefill as jlm_prefill
from repro.serving import ServingEngine as JServingEngine
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.launch import serve
from repro_torch.models import init_caches, lm_generate, lm_prefill
from repro_torch.serving import NULL_PAGE, PagePool, Request, Scheduler, ServingEngine

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # under pytest-xdist, torch's intra-op threads contend with the other
    # workers' and slow the engine runs here many times over
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_page_pool_alloc_free_recycle():
    pool = PagePool(num_pages=6, page_size=4)
    assert pool.free_pages == 5            # page 0 reserved (null)
    a = pool.alloc(10)                     # ceil(10/4) = 3 pages
    assert len(a) == 3 and NULL_PAGE not in a
    b = pool.alloc(4)
    assert len(b) == 1 and set(a).isdisjoint(b)
    assert not pool.can_alloc(8)           # 1 page left, need 2
    pool.free(a)
    assert set(pool.alloc(8)) <= set(a)    # LIFO: freed pages come back
    with pytest.raises(ValueError):
        pool.free([NULL_PAGE])
    with pytest.raises(ValueError):
        pool.free([b[0], b[0]])            # double free


def test_page_pool_share_and_cow():
    pool = PagePool(num_pages=4, page_size=4)
    (p,) = pool.alloc_pages(1)
    pool.share([p])
    assert pool.refcount(p) == 2
    q = pool.cow(p)                        # the writer gets a private copy
    assert q != p and pool.refcount(p) == 1 and pool.refcount(q) == 1
    pool.free([p, q])
    assert pool.free_pages == 3 and pool.live_refs() == 0


def test_scheduler_fifo_admission_and_head_of_line():
    pool = PagePool(num_pages=5, page_size=4)    # 4 usable pages
    sched = Scheduler(pool)
    big = Request(rid=0, prompt=np.zeros(10, np.int32), max_new=6)   # 4 pages
    small = Request(rid=1, prompt=np.zeros(2, np.int32), max_new=2)  # 1 page
    late = Request(rid=2, prompt=np.zeros(2, np.int32), max_new=2, arrival=5)
    sched.submit(big), sched.submit(small), sched.submit(late)
    assert [r.rid for r in sched.admit(tick=0, free_slots=4)] == [0]
    pages = pool.alloc(big.budget_tokens)
    assert sched.admit(tick=0, free_slots=3) == []
    sched.retire(big, pages, tick=3)
    assert [r.rid for r in sched.admit(tick=3, free_slots=3)] == [1]
    pool.alloc(small.budget_tokens)
    assert [r.rid for r in sched.admit(tick=5, free_slots=2)] == [2]


def test_scheduler_same_tick_admissions_reserve_against_each_other():
    pool = PagePool(num_pages=5, page_size=4)
    sched = Scheduler(pool)
    for rid in range(3):                                 # 3 pages each
        sched.submit(Request(rid=rid, prompt=np.zeros(8, np.int32), max_new=4))
    got = sched.admit(tick=0, free_slots=3)
    assert [r.rid for r in got] == [0]
    assert sum(pool.pages_for(r.budget_tokens) for r in got) <= pool.free_pages


def test_scheduler_orders_queue_by_arrival_not_submit_order():
    pool = PagePool(num_pages=5, page_size=4)
    sched = Scheduler(pool)
    sched.submit(Request(rid=0, prompt=np.zeros(2, np.int32), max_new=2,
                         arrival=100))
    sched.submit(Request(rid=1, prompt=np.zeros(2, np.int32), max_new=2))
    assert [r.rid for r in sched.admit(tick=0, free_slots=2)] == [1]


def _pair():
    """(jax cfg, torch cfg, jax packed params, torch packed params)."""
    if not _CACHE:
        jcfg = jmake_smoke(jget_config("qwen1.5-0.5b"), n_layers=2)
        cfg = make_smoke(get_config("qwen1.5-0.5b"), n_layers=2)
        jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
        sel = jknapsack_prune(jparams, sparsity=0.5,
                              blocking=JBlockingSpec(bk=32, bn=32), min_size=1024)
        jpacked = jpack_params(jparams, sel.masks, sel.structures)
        _CACHE["pair"] = (jcfg, cfg, jpacked, params_from_reference(jpacked))
    return _CACHE["pair"]


@pytest.mark.parametrize("shared_prefix", [False, True])
@pytest.mark.parametrize("ticks", [1, 4])
def test_engine_streams_match_reference_engine(ticks, shared_prefix):
    jcfg, cfg, jparams, tparams = _pair()
    rng = np.random.default_rng(ticks + 10 * shared_prefix)
    if shared_prefix:        # a 2-page prefix, request 1 repeats request 0
        prefix = rng.integers(0, cfg.vocab, size=8)
        prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, size=3)])
                   for _ in range(4)]
        prompts[1] = prompts[0].copy()
    else:
        prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 9, 5, 9)]
    prompts = [p.astype(np.int32) for p in prompts]
    gens, arrivals = [6, 4, 5, 6], [0, 0, 2, 5]
    streams = {}
    for name, engine in (
            ("jax", JServingEngine(jparams, jcfg, num_slots=2, page_size=4,
                                   max_seq_len=20, ticks_per_sync=ticks)),
            ("torch", ServingEngine(tparams, cfg, num_slots=2, page_size=4,
                                    max_seq_len=20, ticks_per_sync=ticks,
                                    device="cpu"))):
        for p, g, a in zip(prompts, gens, arrivals):
            engine.submit(p, g, arrival=a)
        done = engine.run()
        streams[name] = [done[i].tokens.tolist() for i in range(len(prompts))]
        streams[name + "_hits"] = engine.prefix_stats["hit_requests"]
        streams[name + "_joins"] = [done[i].admitted_at for i in range(len(prompts))]
    assert streams["torch"] == streams["jax"]
    assert [len(s) for s in streams["torch"]] == gens
    assert streams["torch_joins"] == streams["jax_joins"]
    assert streams["torch_hits"] == streams["jax_hits"]
    assert (streams["torch_hits"] > 0) == shared_prefix


@pytest.mark.parametrize("eos", ["2", "hit"])
def test_eos_generate_and_engine_match_reference(eos):
    """``eos_id`` in ``lm_generate`` and in the engine's decode chunks
    against the JAX package.  Token 2 (the launcher's ``--eos-id 2``)
    never comes up in these random-weight streams, so "hit" takes a
    token the first stream emits mid-way, which must end it early."""
    jcfg, cfg, jparams, tparams = _pair()
    rng = np.random.default_rng(21)
    prompts = rng.integers(0, cfg.vocab, size=(3, 6)).astype(np.int32)
    gen = 8
    jgen = jax.jit(jlm_generate, static_argnames=("num_tokens", "cfg", "eos_id"))

    def generate(eos_id):
        jc = jinit_caches(jcfg, 3, 6 + gen, jnp.float32)
        jl, jc = jax.jit(jlm_prefill, static_argnames=("cfg",))(
            jparams, jc, {"tokens": jnp.asarray(prompts)}, cfg=jcfg)
        first = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        want, _ = jgen(jparams, jc, jnp.asarray(first), jnp.int32(6),
                       num_tokens=gen, cfg=jcfg, eos_id=eos_id)
        tc = init_caches(cfg, 3, 6 + gen, torch.float32, device="cpu")
        with torch.no_grad():
            lm_prefill(tparams, tc, {"tokens": torch.from_numpy(prompts)}, cfg)
        got, _ = lm_generate(tparams, tc, torch.from_numpy(first), 6, gen, cfg,
                             eos_id=eos_id)
        return got.numpy(), np.asarray(want)

    eos_id = 2 if eos == "2" else int(generate(None)[1][0, 3])
    got, want = generate(eos_id)
    np.testing.assert_array_equal(got, want)
    if eos == "hit":
        stop = int(np.argmax(want[0] == eos_id))
        assert stop < gen - 1 and (want[0, stop:] == eos_id).all()
    streams = {}
    for name, engine in (
            ("jax", JServingEngine(jparams, jcfg, num_slots=2, page_size=4,
                                   max_seq_len=20, ticks_per_sync=3,
                                   eos_id=eos_id)),
            ("torch", ServingEngine(tparams, cfg, num_slots=2, page_size=4,
                                    max_seq_len=20, ticks_per_sync=3,
                                    eos_id=eos_id, device="cpu"))):
        for i, p in enumerate(prompts):
            engine.submit(p, gen, arrival=i)
        done = engine.run()
        streams[name] = [done[i].tokens.tolist() for i in range(len(prompts))]
    assert streams["torch"] == streams["jax"]
    if eos == "hit":
        assert len(streams["torch"][0]) < gen and streams["torch"][0][-1] == eos_id


def test_engine_stream_matches_solo_decode_and_drains():
    _, cfg, _, tparams = _pair()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (7, 4, 10)]
    eng = ServingEngine(tparams, cfg, num_slots=2, page_size=4, max_seq_len=16,
                        ticks_per_sync=3, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, 5, arrival=i)
    done = eng.run()
    assert serve.verify_streams(tparams, cfg, done, 5, device="cpu") == []
    eng.release_prefix_cache()
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert eng.pool.live_refs() == 0


def test_serve_stream_smoke_exits_zero(capsys):
    assert serve.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--smoke",
                       "--stream", "--pruned", "0.75", "--requests", "4",
                       "--gen", "6", "--shared-prefix"]) == 0
    out = capsys.readouterr().out
    assert "verify OK" in out and "prefix cache: 3/4" in out


@pytest.mark.parametrize("mode", [
    ["--stream", "--adaptive", "--request-temperatures", "0,0.8"],
    ["--chaos"],
])
def test_serve_adaptive_and_chaos_smokes_exit_zero(capsys, mode):
    # the launcher's default traffic (6 requests, 32 tokens each)
    assert serve.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--smoke",
                       *mode]) == 0
    assert "verify OK" in capsys.readouterr().out
