"""The port's runtime meter (``repro_torch.analysis.runtime``) on the CPU.

Positive controls, the counterparts of the reference's
(``tests/test_analysis.py``'s runtime section): a capture counted by
``CompileTracker``, pulls attributed to their region, a stray pull
raising ``HostSyncError`` with every patch removed afterwards.  Then the
port's engine under ``no_host_sync(strict=True)`` against the JAX
engine under the reference's meter, on the trace of the reference's
``test_engine_steady_state_zero_recompiles_one_sync_per_chunk``: the
same ``admission`` and ``decode_chunk`` region totals, no untagged pull,
the same tokens.  On the CPU the guarded device is the CPU: its tensors
stand for device values, as JAX's CPU arrays do in the reference's test.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import runtime as art

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _VariantCache:
    """A stand-in for ``PackedGraphs``: the first call of a variant
    "captures" it (and counts the capture), later calls replay."""

    def __init__(self):
        self.graphs = {}

    def __call__(self, x, ticks):
        if ticks not in self.graphs:
            art.count_compile()
            self.graphs[ticks] = lambda v: v * ticks
        return self.graphs[ticks](x)

    def _cache_size(self):
        return len(self.graphs)


def test_runtime_compile_tracker_sees_fresh_capture():
    g = _VariantCache()
    tracker = art.CompileTracker(g=g, eager=lambda x: x)
    before = tracker.snapshot()
    g(torch.ones(4), 4)                      # first call captures
    mid = tracker.snapshot()
    g(torch.ones(4), 4)                      # replay
    after = tracker.snapshot()
    assert art.CompileTracker.new_compiles(before, mid)["g"] == 1
    assert art.CompileTracker.new_compiles(before, mid)["_events"] == 1
    assert art.CompileTracker.new_compiles(mid, after) == {"g": 0, "eager": 0, "_events": 0}
    assert before["caches"]["eager"] == -1   # nothing cached: runs eagerly


def test_runtime_sync_region_counts_and_pull_attribution():
    x = torch.arange(8)
    before_regions = art.region_counts().get("unit-test", 0)
    with art.measure_pulls(device=CPU) as pulls:
        with art.sync_region("unit-test"):
            np.asarray(x)
            x.cpu().numpy()
            x[3].item()
    assert art.region_counts()["unit-test"] == before_regions + 1
    assert pulls == {"unit-test": 4}     # np.asarray's __array__/numpy count once


_PATCHED = ("item", "tolist", "numpy", "cpu", "__array__", "__bool__", "__int__",
            "__float__", "__index__", "to", "copy_")


@pytest.mark.parametrize("pull", [
    lambda x: x[3].item(),
    lambda x: x.cpu(),
    lambda x: np.asarray(x),
    lambda x: np.array([x, x]),
    lambda x: x.tolist(),
    lambda x: int(x[0]),
    lambda x: bool(x.sum() > 0),
    lambda x: range(10)[x[1]],
], ids=["item", "cpu", "np.asarray", "np.array-of-list", "tolist", "int", "bool",
        "index"])
def test_runtime_no_host_sync_raises_on_stray_pull(pull):
    x = torch.arange(8)
    dict_before = {n: torch.Tensor.__dict__.get(n) for n in _PATCHED}
    asarray = np.asarray
    with pytest.raises(art.HostSyncError):
        with art.no_host_sync(strict=True, device=CPU):
            pull(x)                          # undeclared pull
    # declared pulls pass, and the patches are removed afterwards
    with art.no_host_sync(strict=True, device=CPU):
        with art.sync_region("declared"):
            assert int(np.asarray(x)[3]) == 3
            pull(x)
    assert {n: torch.Tensor.__dict__.get(n) for n in _PATCHED} == dict_before
    assert np.asarray is asarray
    assert np.asarray(x).shape == (8,)


def test_runtime_in_place_writes_and_same_device_moves_are_no_pulls():
    """On the CPU a copy between CPU tensors and a move to the tensor's
    own device are in-place work, not pulls; a non-strict meter counts
    stray pulls under "<untagged>"."""
    x, y = torch.arange(8.0), torch.zeros(8)
    with art.no_host_sync(strict=True, device=CPU):
        y.copy_(x)
        x.to(CPU)
        x.to(torch.float64)
        z = x * 2 + y
    assert torch.equal(z, 3 * x)
    with art.no_host_sync(strict=False, device=CPU), art.measure_pulls(device=CPU) as pulls:
        x.sum().item()
    assert pulls == {"<untagged>": 1}


# ---------------------------------------------------------------------------
# the engine under the meter against the reference's engine under its own
# ---------------------------------------------------------------------------

_PAIRS = {}


def _pair(kind):
    """Smoke qwen (2 layers), knapsack 0.5 at 32x32, dense or packed:
    (JAX params, port params, JAX config, port config)."""
    if kind not in _PAIRS:
        import jax
        from repro.configs import get_config as jget_config
        from repro.configs import make_smoke as jmake_smoke
        from repro.core import BlockingSpec as JBlockingSpec
        from repro.models import init_params as jinit_params
        from repro.sparse import knapsack_prune as jknapsack_prune
        from repro.sparse import pack_params as jpack_params
        from repro_torch.bridge import params_from_reference
        from repro_torch.configs import get_config, make_smoke

        jcfg = jmake_smoke(jget_config("qwen1.5-0.5b"), n_layers=2)
        cfg = make_smoke(get_config("qwen1.5-0.5b"), n_layers=2)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        if kind == "packed":
            sel = jknapsack_prune(jp, sparsity=0.5, blocking=JBlockingSpec(bk=32, bn=32),
                                  min_size=1024)
            jp = jpack_params(jp, sel.masks, sel.structures)
        _PAIRS[kind] = (jp, params_from_reference(jp, CPU), jcfg, cfg)
    return _PAIRS[kind]


def _metered_trace(engine_cls, params, cfg, meter, prompts, **extra):
    """The reference test's trace: warm-up engine (3 requests), then 6
    staggered requests through a fresh engine, stepped under ``meter``
    with the per-step region checks.  Returns (region deltas, chunks,
    pulls by tag, tokens by rid, statuses, stats before/after)."""
    def build():
        return engine_cls(params, cfg, num_slots=2, page_size=4, max_seq_len=16,
                          ticks_per_sync=2, prefix_caching=False, **extra)

    warm = build()
    for i, p in enumerate(prompts[:3]):
        warm.submit(p, 3, arrival=2 * i)
    assert len(warm.run()) == 3
    eng = build()
    for i, p in enumerate(prompts[3:]):
        eng.submit(p, 3, arrival=2 * i)
    before = eng.analysis_stats()
    chunks = 0
    no_sync, measure = meter
    with no_sync(), measure() as pulls:
        while eng.scheduler.pending or any(s is not None for s in eng.slots):
            regions0 = dict(eng.sync_regions)
            admitted = eng.step()
            active = any(s is not None for s in eng.slots)
            d_chunk = eng.sync_regions["decode_chunk"] - regions0["decode_chunk"]
            d_admit = eng.sync_regions["admission"] - regions0["admission"]
            assert d_chunk <= 1, "more than one transfer boundary in a chunk"
            assert d_admit == admitted, "admission sync without an admission"
            chunks += d_chunk
            if not active and not eng.scheduler.pending and d_chunk == 0:
                break
    after = eng.analysis_stats()
    regions = {k: after["sync_regions"][k] - before["sync_regions"][k]
               for k in ("admission", "decode_chunk")}
    tokens = {rid: [int(t) for t in r.tokens] for rid, r in eng.requests.items()}
    statuses = {r.status.name for r in eng.requests.values()}
    return regions, chunks, dict(pulls), tokens, statuses, before, after


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_engine_steady_state_one_sync_per_chunk_matches_reference(kind):
    """The port's ``test_engine_steady_state_zero_recompiles_one_sync_per_chunk``:
    per step at most one ``decode_chunk`` region and one ``admission``
    region per admission, both engines the same totals, no untagged pull
    in either, every request FINISHED with equal tokens; the port's
    compile caches (-1: eager on the CPU) and compile events unchanged."""
    from repro import serving as jserving
    from repro.analysis import runtime as jart
    from repro_torch import serving as tserving

    jp, tp, jcfg, cfg = _pair(kind)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=6).astype(np.int32) for _ in range(9)]
    j = _metered_trace(jserving.ServingEngine, jp, jcfg,
                       (lambda: jart.no_host_sync(strict=True), jart.measure_pulls),
                       prompts)
    t = _metered_trace(tserving.ServingEngine, tp, cfg,
                       (lambda: art.no_host_sync(strict=True, device=CPU),
                        lambda: art.measure_pulls(device=CPU)),
                       prompts, device="cpu")
    (j_regions, j_chunks, j_pulls, j_tokens, j_status, j_before, j_after) = j
    (t_regions, t_chunks, t_pulls, t_tokens, t_status, t_before, t_after) = t
    assert t_chunks >= 3                      # the loop really decoded in chunks
    assert t_regions == j_regions == {"admission": 6, "decode_chunk": t_chunks}
    assert t_chunks == j_chunks
    assert "<untagged>" not in t_pulls and "<untagged>" not in j_pulls
    assert set(t_pulls) == {"admission", "decode_chunk"}
    assert t_status == j_status == {"FINISHED"}
    assert t_tokens == j_tokens
    for key in ("compile_caches", "compile_events"):
        assert t_after[key] == t_before[key]
    assert t_after["compile_caches"] == {"_decode_chunk": -1, "_paged_prefill_step": -1}
    assert j_after["compile_caches"] == j_before["compile_caches"]


def test_stray_pull_in_the_engine_raises_in_both_packages(monkeypatch):
    """A pull the engine does not declare raises under either meter: a
    pull slipped in after each package's admission prefill."""
    from repro import serving as jserving
    from repro.analysis import runtime as jart
    from repro.serving import engine as jengine
    from repro_torch import serving as tserving
    from repro_torch.serving import engine as tengine

    jp, tp, jcfg, cfg = _pair("dense")
    prompt = np.arange(1, 7, dtype=np.int32)
    orig = tengine._paged_prefill_step

    def leaky(*a, **k):
        first, ok = orig(*a, **k)
        first.sum().item()                       # the stray pull
        return first, ok

    monkeypatch.setattr(tengine, "_paged_prefill_step", leaky)
    eng = tserving.ServingEngine(tp, cfg, num_slots=2, page_size=4, max_seq_len=16,
                                 ticks_per_sync=2, device="cpu")
    eng.submit(prompt, 3)
    with pytest.raises(art.HostSyncError, match="Tensor.item"):
        with art.no_host_sync(strict=True, device=CPU):
            eng.run()
    jorig = jengine._paged_prefill_step

    def jleaky(*a, **k):
        first, ok, caches = jorig(*a, **k)
        np.asarray(first)                        # the stray pull
        return first, ok, caches

    monkeypatch.setattr(jengine, "_paged_prefill_step", jleaky)
    jeng = jserving.ServingEngine(jp, jcfg, num_slots=2, page_size=4, max_seq_len=16,
                                  ticks_per_sync=2)
    jeng.submit(prompt, 3)
    with pytest.raises(jart.HostSyncError, match="np.asarray"):
        with jart.no_host_sync(strict=True):
            jeng.run()


@pytest.mark.cuda
def test_chunk_graphs_capture_counted_and_replays_metered():
    """On the card: a real ``PackedGraphs`` capture counts one compile
    event and one cached variant; its replays pass the strict meter (the
    transfer is declared) and capture nothing new."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    from repro_torch.serving.engine import _chunk_label
    from repro_torch.serving.graphs import PackedGraphs

    dev = torch.device("cuda")
    state = torch.zeros(4, dtype=torch.int32, device=dev)

    def fn(packed, ticks, sampled):
        return packed * ticks + state

    graphs = PackedGraphs(fn, 4, dev, region="decode_chunk", label=_chunk_label)
    tracker = art.CompileTracker(chunk=graphs)
    before = tracker.snapshot()
    first = graphs(np.arange(4, dtype=np.int32), 2, False)
    mid = tracker.snapshot()
    with art.no_host_sync(strict=True), art.measure_pulls() as pulls:
        again = graphs(np.arange(4, dtype=np.int32), 2, False)
    after = tracker.snapshot()
    assert np.array_equal(first, again) and list(again) == [0, 2, 4, 6]
    assert art.CompileTracker.new_compiles(before, mid) == {"chunk": 1, "_events": 1}
    assert art.CompileTracker.new_compiles(mid, after) == {"chunk": 0, "_events": 0}
    assert set(pulls) == {"decode_chunk"}


@pytest.mark.cuda
def test_admission_upload_does_not_block_on_the_card():
    """On the card a pageable host-to-device copy is a host sync that the
    strict meter refuses (CUDA's sync-debug mode "error"); the engine's
    pinned, non-blocking upload is not."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sync-debug mode exists only on the card")
    import types

    from repro_torch.serving import ServingEngine

    a = np.arange(64, dtype=np.int32)[None]
    card = types.SimpleNamespace(device=torch.device("cuda"))
    with art.no_host_sync(strict=True):
        with pytest.raises(RuntimeError, match="synchronizing CUDA operation"):
            torch.as_tensor(a, device="cuda")
        up = ServingEngine._upload(card, a)
    torch.cuda.synchronize()
    assert up.is_cuda and torch.equal(up.cpu(), torch.from_numpy(a))
