"""The engine's packed admission prefill against the JAX package's
``_paged_prefill_step``, on the CPU, and its CUDA graphs on the card.

``repro_torch.serving.engine._paged_prefill_step`` takes ONE packed
int32 vector (the prompt tail, the slot's page-table row, the slot) and
returns ONE int32 block (the first token, the all-finite flag); a
recurrent layer prefills into a one-row scratch cache and lands in row
``slot`` of the pool through an ``index_copy_`` on the device.  Here the
same smoke-size params (the reference's, bridged by
``repro_torch.bridge``) and the same pools go through both packages'
steps, at slot 0 and at another slot, and the first token, the flag,
every pool page and every recurrent row are compared: tokens and flags
exactly, fp32 pages and rows within 1e-5 relative to each tensor's
largest entry (``max|torch - jax| / max(1, max|jax|)``, the measure of
the repo's other fp32 parity tests).  The recurrent rows
start from random values (the same in both) so that a write to the
wrong row, or a reset of a row the step must leave alone, shows.

On the card (``cuda``-marked, skipped here) the engine runs each
admission prefill as a CUDA graph per ``(L, start, guard)``: graphed
streams equal eager ones, a second admission of a seen variant captures
nothing, and a failed capture raises ``GraphFailure`` without an eager
retry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.models import init_params as jinit_params
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import _paged_prefill_step as jprefill
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as tengine

from chip_smoke import EMBED_SCALE

# fp32 pages and rows: max|torch - jax| / max(1, max|jax|) per tensor,
# the repo's fp32 measure (XLA and torch sum in different orders)
TOL = 1e-5
KW = dict(num_slots=3, page_size=4, max_seq_len=24)
_CACHE = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(arch):
    """(jax cfg, torch cfg, jax params, torch params) at smoke size; the
    recurrent stacks at 8 layers (jamba's attention layer, xLSTM's
    sLSTM) with the embedding scaled as the engine tests scale it."""
    if arch not in _CACHE:
        recurrent = arch.startswith(("jamba", "xlstm"))
        kw = {"n_layers": 8} if recurrent else {}
        jcfg = jmake_smoke(jget_config(arch), **kw)
        cfg = make_smoke(get_config(arch), **kw)
        jp = jinit_params(jax.random.PRNGKey(3), jcfg)
        if recurrent:
            jp = {**jp, "embed": {"embedding": jp["embed"]["embedding"]
                                  * EMBED_SCALE}}
        _CACHE[arch] = (jcfg, cfg, jp, params_from_reference(jp))
    return _CACHE[arch]


def _engines(arch, seed=0):
    """A JAX and a torch engine whose recurrent rows hold the same random
    values (the JAX pools as distinct buffers: its sLSTM cache aliases
    ``c`` and ``h``)."""
    jcfg, cfg, jp, tp = _pair(arch)
    jeng = JServingEngine(jp, jcfg, **KW)
    teng = ServingEngine(tp, cfg, device="cpu", **KW)
    rng = np.random.default_rng(seed)
    jcaches = []
    for jc, tc, attn in zip(jeng.caches, teng.caches, teng._attn):
        new = {}
        for k, t in tc.items():
            if not attn:
                t.copy_(torch.from_numpy(
                    rng.standard_normal(tuple(t.shape)).astype(np.float32)))
            new[k] = jnp.asarray(t.numpy().copy())
        jcaches.append(new)
    jeng.caches = jcaches
    return jcfg, cfg, jp, tp, jeng, teng


def _table(teng, pages):
    row = np.zeros((teng.max_pages,), np.int32)
    row[:len(pages)] = pages
    return row


def _step_both(jcfg, cfg, jp, tp, jeng, teng, tokens, pages, slot, start):
    """One prefill through each package's step; returns ((first, ok) of
    the JAX step, the torch step's packed block)."""
    table = _table(teng, pages)
    first, ok, jeng.caches = jprefill(
        jp, jnp.asarray(tokens[None]), jeng.caches, jnp.asarray(table[None]),
        slot, cfg=jcfg, start=start, guard=True)
    packed = torch.from_numpy(np.concatenate([tokens, table, [slot]]).astype(np.int32))
    out = tengine._paged_prefill_step(
        tp, teng.caches, packed, cfg=cfg, max_pages=teng.max_pages,
        fresh_rows=teng._fresh_rows, scratch_rows=teng._scratch_rows,
        start=start, guard=True)
    return (int(first[0]), int(bool(ok))), out


def _assert_caches_equal(jeng, teng):
    for jc, tc in zip(jeng.caches, teng.caches):
        assert sorted(jc) == sorted(tc)
        for k in tc:
            got, want = tc[k].numpy(), np.asarray(jc[k])
            assert got.shape == want.shape, k
            err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
            assert err <= TOL, (k, err)


@pytest.mark.parametrize("arch,slot", [("qwen1.5-0.5b", 0),
                                       ("granite-moe-1b-a400m", 1),
                                       ("jamba-v0.1-52b", 0),
                                       ("jamba-v0.1-52b", 2),
                                       ("xlstm-350m", 0),
                                       ("xlstm-350m", 2)])
def test_packed_prefill_step_equals_reference(arch, slot):
    """First token, flag, every pool page and every recurrent row equal
    the JAX step's at the same slot and table (``start = 0``)."""
    jcfg, cfg, jp, tp, jeng, teng = _engines(arch)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, 11).astype(np.int32)
    want, out = _step_both(jcfg, cfg, jp, tp, jeng, teng, tokens,
                           [3, 5, 2], slot, 0)
    assert out.dtype == torch.int32 and out.shape == (2,)
    assert tuple(out.tolist()) == want
    _assert_caches_equal(jeng, teng)


def test_packed_prefill_tail_at_start_equals_reference():
    """qwen: a whole prompt at ``start = 0``, then a second prompt that
    shares its first two pages prefilled as the tail at ``start = 8``
    over those pages, into another slot."""
    jcfg, cfg, jp, tp, jeng, teng = _engines("qwen1.5-0.5b")
    rng = np.random.default_rng(2)
    first = rng.integers(0, cfg.vocab, 10).astype(np.int32)
    second = np.concatenate([first[:8], rng.integers(0, cfg.vocab, 7)]).astype(np.int32)
    want, out = _step_both(jcfg, cfg, jp, tp, jeng, teng, first, [1, 2, 3], 0, 0)
    assert tuple(out.tolist()) == want
    want, out = _step_both(jcfg, cfg, jp, tp, jeng, teng, second[8:],
                           [1, 2, 4, 6], 1, 8)
    assert tuple(out.tolist()) == want
    _assert_caches_equal(jeng, teng)


class _Recorder:
    """A stand-in for the engine's prefill ``PackedGraphs`` on the CPU:
    records each call's variant and runs the packed step eagerly."""

    def __init__(self, fn):
        self.fn, self.variants, self.sizes = fn, [], []

    def run(self, packed_in, variant, within=None):
        self.variants.append(variant)
        self.sizes.append(len(packed_in))
        out = self.fn(torch.from_numpy(packed_in), *variant).numpy()
        return out, within() if within is not None else None


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "xlstm-350m"])
def test_variant_key_is_length_start_guard_never_the_slot(arch):
    """Requests of one prompt length admitted into different slots run
    one variant ``(L, 0, guard)`` over packed inputs of one length, and
    the engine that goes through the graph cache's interface serves the
    same streams as the eager one."""
    _, cfg, _, tp = _pair(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 7).astype(np.int32) for _ in range(3)]
    runs = {}
    for name in ("eager", "recorded"):
        eng = ServingEngine(tp, cfg, device="cpu", prefix_caching=False, **KW)
        if name == "recorded":
            eng.prefill_graphs = rec = _Recorder(eng._prefill_fn)
        for p in prompts:
            eng.submit(p, 4)
        done = eng.run()
        runs[name] = [done[i].tokens.tolist() for i in range(3)]
        slots = list(eng.admissions_by_slot)
    assert runs["recorded"] == runs["eager"]
    assert slots == [1, 1, 1]
    assert rec.variants == [(7, 0, True)] * 3
    assert len(set(rec.variants)) == 1 and len(set(rec.sizes)) == 1


def test_prefix_hit_variant_carries_its_start():
    """With prefix caching a repeated prompt is admitted as its tail at
    the page-aligned hit length: the variant is ``(L - start, start,
    guard)``; the streams equal the eager engine's."""
    _, cfg, _, tp = _pair("qwen1.5-0.5b")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, 10).astype(np.int32)
    runs = {}
    for name in ("eager", "recorded"):
        eng = ServingEngine(tp, cfg, device="cpu", **KW)
        if name == "recorded":
            eng.prefill_graphs = rec = _Recorder(eng._prefill_fn)
        eng.submit(prompt, 4)
        eng.submit(prompt, 4, arrival=2)
        done = eng.run()
        runs[name] = [done[i].tokens.tolist() for i in range(2)]
    assert runs["recorded"] == runs["eager"]
    assert rec.variants == [(10, 0, True), (2, 8, True)]


def test_cpu_engine_reports_eager_prefill():
    """On the CPU the prefill runs eagerly: no graph cache, its compile
    cache -1, and ``cuda_graphs=True`` still raises."""
    _, cfg, _, tp = _pair("qwen1.5-0.5b")
    eng = ServingEngine(tp, cfg, device="cpu", **KW)
    assert eng.prefill_graphs is None and eng.graph_pool_bytes() is None
    an = eng.analysis_stats()
    assert an["compile_caches"]["_paged_prefill_step"] == -1
    assert an["prefill_captures"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        ServingEngine(tp, cfg, device="cpu", cuda_graphs=True, **KW)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


def _serve(eng, prompts, gen=5):
    first = eng._next_rid
    for i, p in enumerate(prompts):
        eng.submit(p, gen, arrival=eng.tick + i)
    done = eng.run()
    return [done[first + i].tokens.tolist() for i in range(len(prompts))]


def _card_params(arch, card):
    """Smoke params made on the card from a seed; qwen at head_dim 64,
    which the paged kernels take."""
    from repro_torch.launch import serve
    kw = {"n_layers": 8} if arch.startswith("xlstm") else {"head_dim": 64}
    cfg = make_smoke(get_config(arch), **kw)
    return cfg, serve.build_params(cfg, seed=0, device=card)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "xlstm-350m"])
def test_graphed_prefill_engine_equals_eager(card, arch):
    """Two passes (the second hits the first's prefixes on qwen) through
    an eager and a graphed engine: the same streams, every admission a
    graph of its (L, start) variant, and every slot used."""
    cfg, tp = _card_params(arch, card)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 6, 9, 11)]
    out = {}
    for graphed in (False, True):
        eng = ServingEngine(tp, cfg, device=card, cuda_graphs=graphed, **KW)
        out[graphed] = [_serve(eng, prompts) for _ in range(2)]
    assert out[True] == out[False]
    an = eng.analysis_stats()
    assert an["compile_caches"]["_paged_prefill_step"] == an["prefill_captures"] > 0
    assert sum(an["prefill_replays"].values()) + an["prefill_captures"] == 8
    assert min(an["admissions_by_slot"]) >= 1


@pytest.mark.cuda
def test_seen_prefill_variant_replays_without_capture(card):
    """Admitting a seen (L, start) again replays its graph: no capture,
    no compile event, one more replay."""
    from repro_torch.analysis import runtime as art
    cfg, tp = _card_params("qwen1.5-0.5b", card)
    eng = ServingEngine(tp, cfg, device=card, prefix_caching=False, **KW)
    prompt = np.arange(1, 8, dtype=np.int32)
    _serve(eng, [prompt])
    before, events = eng.analysis_stats(), art.compile_events()
    _serve(eng, [prompt[::-1].copy()])
    after = eng.analysis_stats()
    assert after["prefill_variants"] == before["prefill_variants"] == ["7@0"]
    assert art.compile_events() == events
    assert after["prefill_replays"]["7@0"] == before["prefill_replays"]["7@0"] + 1


@pytest.mark.cuda
def test_failed_prefill_capture_raises_and_is_not_retried(card, monkeypatch):
    """A prefill that reads a device value on the host cannot be
    captured: the engine raises ``GraphFailure`` out of ``step`` and runs
    the step no third time (its warm-up, the failed capture, no eager
    retry); nothing is admitted."""
    from repro_torch.serving import GraphFailure
    cfg, tp = _card_params("qwen1.5-0.5b", card)
    eng = ServingEngine(tp, cfg, device=card, **KW)
    calls = []
    orig = tengine._paged_prefill_step

    def syncing(params, caches, packed, **kw):
        calls.append(len(calls))
        int(packed.sum())                          # a host read
        return orig(params, caches, packed, **kw)

    monkeypatch.setattr(tengine, "_paged_prefill_step", syncing)
    eng.submit(np.arange(1, 6, dtype=np.int32), 3)
    with pytest.raises(GraphFailure):
        eng.step()
    assert len(calls) == 2
    assert eng.sync_regions["admission"] == 0
    assert all(s is None for s in eng.slots)
