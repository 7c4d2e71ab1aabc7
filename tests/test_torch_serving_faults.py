"""Fault-tolerant serving of the port against the JAX package, on the CPU.

Port counterparts of ``tests/test_serving_faults.py``: reject, cancel,
deadline, NaN quarantine, a chunk exception with degrade, repeated
failures, index corruption, an allocation failure, faults in the middle
of an adaptive chunk, and the property that chaos traces conserve pages.
Each trace runs through the JAX engine and the port's on the same
bridged, pruned and packed params (``test_torch_slo.both``): the port's
statuses, reasons, emitted tokens, ``fault_stats`` and chunk history
must equal the reference's, and the port's own streams are held to its
solo decode.
"""
import numpy as np
import pytest
import torch

from repro_torch import serving as tserving
from repro_torch.kernels import _build
from test_torch_slo import both, models, prompts, solo

RS = tserving.RequestStatus


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pool_conserved(eng):
    """Every pool reference belongs to an active slot's table or to the
    prefix-index ledger, and the free list holds exactly the rest."""
    refs = {}
    for s in eng.slots:
        if s is not None:
            for p in s.pages:
                refs[p] = refs.get(p, 0) + 1
    if eng.prefix_index is not None:
        for p, c in eng.prefix_index._owned.items():
            refs[p] = refs.get(p, 0) + c
    for p in range(1, eng.pool.num_pages):
        assert eng.pool.refcount(p) == refs.get(p, 0), p
    assert eng.pool.free_pages == (eng.pool.num_pages - 1) - len(refs)


def _drained(eng):
    eng.release_prefix_cache()
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert eng.pool.live_refs() == 0


def test_submit_rejects_out_of_range_token_ids():
    _, side = models()
    eng = side.engine(num_slots=2, page_size=4, max_seq_len=16)
    vocab = side.cfg.vocab
    with pytest.raises(ValueError, match=f"id {vocab} at position 2"):
        eng.submit(np.array([1, 2, vocab, 3], np.int32), 4)
    with pytest.raises(ValueError, match="id -1 at position 0"):
        eng.submit(np.array([-1, 2], np.int32), 4)
    assert not eng.requests and eng.scheduler.pending == 0


def test_bounded_queue_rejects_over_capacity():
    def scenario(side):
        rng = np.random.default_rng(0)
        eng = side.engine(num_slots=1, page_size=4, max_seq_len=16,
                          max_queue=2)
        for p in prompts(rng, side.cfg.vocab, [5, 7, 6, 5]):
            eng.submit(p, 3)
        eng.run()
        return eng
    eng = both(scenario)
    st = [eng.requests[r].status for r in range(4)]
    assert st == [RS.FINISHED] * 2 + [RS.REJECTED] * 2
    assert all("queue full" in eng.requests[r].status_reason for r in (2, 3))
    assert eng.fault_stats["rejected"] == 2
    assert eng.fault_stats["queue_high_water"] == 2
    for r in (0, 1):
        np.testing.assert_array_equal(eng.requests[r].tokens,
                                      solo(eng, eng.requests[r], 3))
    _pool_conserved(eng)


def test_cancel_waiting_and_active():
    seen = {}

    def scenario(side):
        rng = np.random.default_rng(1)
        ps = prompts(rng, side.cfg.vocab, [5, 9, 7])
        eng = side.engine(num_slots=2, page_size=4, max_seq_len=16,
                          ticks_per_sync=2)
        r0, r1 = eng.submit(ps[0], 6), eng.submit(ps[1], 6)
        r2 = eng.submit(ps[2], 6, arrival=50)
        seen[side.name] = [eng.cancel(r2).value]
        eng.step()
        seen[side.name].append(eng.cancel(r1).value)
        eng.step()
        seen[side.name].append(eng.cancel(r1).value)
        with pytest.raises(KeyError):
            eng.cancel(999)
        eng.run()
        return eng
    eng = both(scenario)
    assert seen["torch"] == seen["jax"] == ["cancelled", "active", "cancelled"]
    r0, r1, r2 = (eng.requests[r] for r in range(3))
    assert r1.status is RS.CANCELLED and 0 < len(r1.tokens) < 6
    np.testing.assert_array_equal(r1.tokens, solo(eng, r1, 6)[:len(r1.tokens)])
    assert r2.status is RS.CANCELLED and len(r2.tokens) == 0
    np.testing.assert_array_equal(r0.tokens, solo(eng, r0, 6))
    assert eng.fault_stats["cancelled"] == 2
    _drained(eng)


def test_deadline_expires_waiting_and_active():
    def scenario(side):
        rng = np.random.default_rng(2)
        ps = prompts(rng, side.cfg.vocab, [5, 9])
        eng = side.engine(num_slots=1, page_size=4, max_seq_len=16,
                          ticks_per_sync=2)
        eng.submit(ps[0], 10, deadline_ticks=5)
        eng.submit(ps[1], 7, deadline_ticks=3)
        eng.run()
        return eng
    eng = both(scenario)
    r0, r1 = eng.requests[0], eng.requests[1]
    assert r0.status is RS.EXPIRED and 0 < len(r0.tokens) < 10
    np.testing.assert_array_equal(r0.tokens, solo(eng, r0, 10)[:len(r0.tokens)])
    assert r1.status is RS.EXPIRED and len(r1.tokens) == 0
    assert "queued" in r1.status_reason
    assert eng.fault_stats["expired"] == 2
    _pool_conserved(eng)


@pytest.mark.parametrize("sampled", [False, True])
def test_nan_guard_quarantines_only_poisoned_row(sampled):
    """NaN written into one request's pages mid-stream (in place, in the
    pool a CUDA graph would replay over): only that row fails; the other
    rows, greedy or sampled, stream on as if alone."""
    def scenario(side):
        rng = np.random.default_rng(3)
        inj = side.mod.FaultInjector([side.mod.nan_logit(2, rid=1)], seed=0)
        eng = side.engine(num_slots=3, page_size=4, max_seq_len=16,
                          ticks_per_sync=2, fault_injector=inj)
        for i, p in enumerate(prompts(rng, side.cfg.vocab, [5, 9, 7])):
            eng.submit(p, 6, temperature=0.9 if sampled and i != 1 else None)
        eng.run()
        assert not inj.pending
        return eng
    eng = both(scenario)
    bad = eng.requests[1]
    assert bad.status is RS.FAILED and "non-finite" in bad.status_reason
    assert 0 < len(bad.tokens) < 6
    np.testing.assert_array_equal(bad.tokens, solo(eng, bad, 6)[:len(bad.tokens)])
    for r in (0, 2):
        req = eng.requests[r]
        assert req.status is RS.FINISHED
        np.testing.assert_array_equal(req.tokens, solo(eng, req, 6))
    assert eng.fault_stats["failed"] == 1 == eng.fault_stats["guard_trips"]
    _pool_conserved(eng)
    _drained(eng)


def test_chunk_exception_restores_snapshot_and_degrades():
    def scenario(side):
        rng = np.random.default_rng(5)
        inj = side.mod.FaultInjector([side.mod.chunk_exception(2)], seed=0)
        eng = side.engine(num_slots=2, page_size=4, max_seq_len=16,
                          ticks_per_sync=2, fault_injector=inj)
        for i, p in enumerate(prompts(rng, side.cfg.vocab, [5, 9])):
            eng.submit(p, 6, temperature=0.7 if i else None)
        eng.run()
        return eng
    eng = both(scenario)
    for req in eng.requests.values():
        assert req.status is RS.FINISHED
        np.testing.assert_array_equal(req.tokens, solo(eng, req, 6))
    st = eng.fault_stats
    assert st["chunk_failures"] == 1 and st["degraded"] == 1
    assert eng.ticks_per_sync == 1 and eng.configured_ticks_per_sync == 2
    assert "InjectedFault" in eng.last_chunk_error
    _pool_conserved(eng)


def test_repeated_chunk_failures_give_up_loudly():
    _, side = models()
    rng = np.random.default_rng(6)
    [p] = prompts(rng, side.cfg.vocab, [5])
    inj = tserving.FaultInjector([tserving.chunk_exception(t) for t in range(40)],
                                 seed=0)
    eng = side.engine(num_slots=1, page_size=4, max_seq_len=16,
                      max_chunk_failures=3, fault_injector=inj)
    eng.submit(p, 8)
    with pytest.raises(RuntimeError, match="consecutive decode-chunk"):
        eng.run()
    assert eng.fault_stats["chunk_failures"] == 4


def test_index_corruption_detected_dropped_and_served_through():
    def scenario(side):
        rng = np.random.default_rng(7)
        inj = side.mod.FaultInjector([side.mod.index_corruption(3)], seed=0)
        eng = side.engine(num_slots=2, page_size=4, max_seq_len=16,
                          ticks_per_sync=2, fault_injector=inj)
        for p, a in zip(prompts(rng, side.cfg.vocab, [9, 9, 7]), (0, 0, 6)):
            eng.submit(p, 6, arrival=a)
        eng.run()
        assert [k for k, _, _ in inj.fired] == ["index_corrupt"]
        return eng
    eng = both(scenario)
    assert eng.fault_stats["index_drops"] == 1
    for req in eng.requests.values():
        assert req.status is RS.FINISHED
        np.testing.assert_array_equal(req.tokens, solo(eng, req, 6))
    _pool_conserved(eng)
    _drained(eng)


def test_index_corruption_seeded_choice_matches_reference():
    """The same plan and seed scramble the same entry to the same page."""
    fired = {}

    def scenario(side):
        rng = np.random.default_rng(8)
        inj = side.mod.FaultInjector([side.mod.index_corruption(2)], seed=5)
        eng = side.engine(num_slots=2, page_size=4, max_seq_len=20,
                          ticks_per_sync=1, fault_injector=inj)
        for p in prompts(rng, side.cfg.vocab, [13, 9, 12]):
            eng.submit(p, 4)
        eng.run()
        fired[side.name] = inj.fired
        return eng
    both(scenario)
    assert fired["torch"] == fired["jax"]


def test_alloc_failure_unwinds_and_retries():
    def scenario(side):
        rng = np.random.default_rng(8)
        inj = side.mod.FaultInjector([side.mod.alloc_failure(0, count=2)],
                                     seed=0)
        eng = side.engine(num_slots=2, page_size=4, max_seq_len=16,
                          fault_injector=inj)
        for p in prompts(rng, side.cfg.vocab, [5, 7]):
            eng.submit(p, 6)
        eng.run()
        return eng
    eng = both(scenario)
    assert eng.fault_stats["alloc_failures"] == 2
    r0, r1 = eng.requests[0], eng.requests[1]
    assert r0.admitted_at <= r1.admitted_at
    for req in (r0, r1):
        assert req.status is RS.FINISHED
        np.testing.assert_array_equal(req.tokens, solo(eng, req, 6))
    _pool_conserved(eng)


def test_lifecycle_faults_fire_mid_adaptive_chunk():
    def scenario(side):
        rng = np.random.default_rng(31)
        ps = prompts(rng, side.cfg.vocab, [5, 7, 6, 5, 5])
        eng = side.engine(num_slots=2, page_size=4, max_seq_len=16,
                          ticks_per_sync=16,
                          chunk_policy=side.mod.AdaptiveChunkPolicy(),
                          max_queue=4)
        eng.submit(ps[0], 8)
        eng.submit(ps[1], 8, deadline_ticks=4)
        eng.submit(ps[2], 6, arrival=2)
        eng.submit(ps[3], 6, arrival=3, temperature=0.8, top_p=0.9)
        eng.submit(ps[4], 4)
        eng.cancel(2)
        eng.run()
        return eng
    eng = both(scenario)
    st = [eng.requests[r].status for r in range(5)]
    assert st == [RS.FINISHED, RS.EXPIRED, RS.CANCELLED, RS.FINISHED,
                  RS.REJECTED]
    r1 = eng.requests[1]
    np.testing.assert_array_equal(r1.tokens, solo(eng, r1, 8)[:len(r1.tokens)])
    for r, g in ((0, 8), (3, 6)):
        np.testing.assert_array_equal(eng.requests[r].tokens,
                                      solo(eng, eng.requests[r], g))
    slo = eng.slo_stats()
    assert set(slo["chunks_by_ticks"]) <= set(eng.chunk_policy.compile_levels)
    assert len(slo["chunks_by_ticks"]) >= 2
    _pool_conserved(eng)


def test_chunk_crash_degrades_adaptive_without_deadlock():
    def scenario(side):
        rng = np.random.default_rng(32)
        inj = side.mod.FaultInjector([side.mod.chunk_exception(2)], seed=0)
        eng = side.engine(num_slots=2, page_size=4, max_seq_len=16,
                          ticks_per_sync=16,
                          chunk_policy=side.mod.AdaptiveChunkPolicy(),
                          fault_injector=inj)
        for i, p in enumerate(prompts(rng, side.cfg.vocab, [5, 9])):
            eng.submit(p, 6, arrival=4 * i)
        eng.run()
        return eng
    eng = both(scenario)
    for req in eng.requests.values():
        assert req.status is RS.FINISHED
        np.testing.assert_array_equal(req.tokens, solo(eng, req, 6))
    assert eng.fault_stats["chunk_failures"] == 1 == eng.fault_stats["degraded"]
    assert eng.ticks_per_sync == 1
    assert eng.slo_stats()["chunks_by_ticks"].get(1, 0) >= 1
    _pool_conserved(eng)


def _chaos_trace(side, seed, check_each_step):
    rng = np.random.default_rng(100 + seed)
    m = side.mod
    faults = []
    for t in sorted(rng.integers(0, 12, size=3)):
        kind = rng.choice(["nan", "alloc", "chunk", "corrupt"])
        faults.append({"nan": m.nan_logit(int(t)),
                       "alloc": m.alloc_failure(int(t)),
                       "chunk": m.chunk_exception(int(t)),
                       "corrupt": m.index_corruption(int(t))}[kind])
    inj = m.FaultInjector(faults, seed=seed)
    policy = m.AdaptiveChunkPolicy((1, 2, 4)) if seed % 2 else None
    eng = side.engine(num_slots=2, page_size=4, max_seq_len=16,
                      ticks_per_sync=int(rng.choice([1, 2])), max_queue=4,
                      fault_injector=inj, chunk_policy=policy, seed=seed)
    rids = []
    for _ in range(int(rng.integers(3, 7))):
        prompt = rng.integers(0, side.cfg.vocab, size=int(rng.integers(3, 10)))
        dl = int(rng.integers(2, 15)) if rng.integers(3) == 0 else None
        rids.append(eng.submit(
            prompt.astype(np.int32), int(rng.integers(2, 7)),
            arrival=int(rng.integers(0, 8)), deadline_ticks=dl,
            priority=int(rng.integers(0, 3)),
            temperature=float(rng.choice([0.0, 0.9])),
            ttft_target_ticks=(int(rng.integers(2, 10)) if rng.integers(2)
                               else None)))
    steps = 0
    while (eng.scheduler.pending or any(s is not None for s in eng.slots)
           or not all(eng.requests[r].terminal for r in rids)):
        if rng.integers(4) == 0 and rids:
            eng.cancel(int(rng.choice(rids)))
        eng.step()
        check_each_step(eng)
        steps += 1
        assert steps < 200, f"trace {seed} did not converge"
    return eng


@pytest.mark.parametrize("seed", range(6))
def test_property_chaos_traces_conserve_pages(seed):
    """Random admit/cancel/expire/fail/crash traces (half under the
    adaptive policy, mixed greedy and sampled): the pool balances after
    every step, every request ends terminal, the pool drains — and the
    port ends each trace exactly where the reference does."""
    eng = both(lambda side: _chaos_trace(
        side, seed, _pool_conserved if side.name == "torch" else
        (lambda e: None)))
    for req in eng.requests.values():
        assert req.status in tserving.TERMINAL_STATUSES
        assert req.tokens is not None
    if eng.chunk_policy is not None:
        assert set(eng.chunks_by_ticks) <= set(eng.chunk_policy.compile_levels)
    _drained(eng)


def test_eager_chunks_count_no_launches_on_cpu():
    """On the CPU the chunk runs the plain versions: a run leaves every
    launch count where it was (the counts move only where a wrapper
    launches a kernel, or a graph replays its recorded launches)."""
    _, side = models()
    before = dict(_build.launch_counts)
    eng = side.engine(num_slots=2, page_size=4, max_seq_len=16,
                      ticks_per_sync=2)
    assert eng.graphs is None and eng.analysis_stats()["cuda_graphs"] == 0
    for p in prompts(np.random.default_rng(9), side.cfg.vocab, [5, 7]):
        eng.submit(p, 4, temperature=0.5)
    eng.run()
    assert _build.launch_counts == before
    an = eng.analysis_stats()
    assert an["captures"] == 0
    assert an["sync_regions"] == {"admission": 2,
                                  "decode_chunk": sum(eng.chunks_by_ticks.values())}


def test_recorded_launches_are_taken_back_and_replayed():
    """A capture's launches are recorded, not counted; each replay adds
    them (the accounting a CUDA graph replay goes through)."""
    before = dict(_build.launch_counts)
    with _build.recorded_launches() as rec:
        _build.launch_counts["bsr_matmul"] += 7
        _build.launch_counts["paged_attention_decode"] += 2
    assert _build.launch_counts == before
    assert rec == {"bsr_matmul": 7, "paged_attention_decode": 2}
    _build.add_launches(rec)
    _build.add_launches(rec)
    assert _build.launch_counts["bsr_matmul"] == before["bsr_matmul"] + 14
    for name, n in before.items():
        _build.launch_counts[name] = n


def test_cuda_graphs_need_a_cuda_device():
    _, side = models()
    with pytest.raises(ValueError, match="cuda_graphs"):
        side.engine(num_slots=1, page_size=4, max_seq_len=16, cuda_graphs=True)
