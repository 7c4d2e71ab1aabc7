"""The port's adaptive chunk policy and SLO accounting against the JAX
package's, on the CPU.

``repro_torch.serving.slo`` is a host-only copy of the reference's
module: for any ``ChunkSignals`` the port's ``AdaptiveChunkPolicy`` must
pick the reference's chunk length.  The port's engine with a policy must
emit the JAX engine's streams — greedy and sampled, on the same bridged,
knapsack-pruned and BSR-packed params — with the same committed chunk
lengths, shrink/grow counts and ``slo_stats``.  Streams must be
bit-identical across fixed and adaptive policies.

The shared helpers (``models``, ``both``, ``summary``) drive one
scenario through both engines; ``tests/test_torch_serving_faults.py``
uses them too.
"""
import types

import jax
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.models import init_params as jinit_params
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch import serving as tserving
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.launch import serve

_MODELS = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def models():
    """Smoke qwen (2 layers), knapsack-pruned at 0.5 with 32x32 blocks and
    BSR-packed, its final norm scaled by 0.02 so that sampling chooses:
    (JAX side, port side) namespaces with each package's engine, policy
    and fault constructors and the same params."""
    if not _MODELS:
        jcfg = jmake_smoke(jget_config("qwen1.5-0.5b"), n_layers=2)
        cfg = make_smoke(get_config("qwen1.5-0.5b"), n_layers=2)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        jp["final_norm"] = {"scale": jp["final_norm"]["scale"] * 0.02}
        sel = jknapsack_prune(jp, sparsity=0.5,
                              blocking=JBlockingSpec(bk=32, bn=32),
                              min_size=1024)
        jpacked = jpack_params(jp, sel.masks, sel.structures)
        tpacked = params_from_reference(jpacked)
        for name, mod, c, p, extra in (
                ("jax", jserving, jcfg, jpacked, {}),
                ("torch", tserving, cfg, tpacked, {"device": "cpu"})):
            ns = types.SimpleNamespace(name=name, mod=mod, cfg=c, params=p)
            ns.engine = (lambda mod=mod, c=c, p=p, extra=extra, **kw:
                         mod.ServingEngine(p, c, **extra, **kw))
            _MODELS[name] = ns
    return _MODELS["jax"], _MODELS["torch"]


def summary(eng):
    """What must agree between the engines after a run: each request's
    status, reason and tokens, the fault counters and the chunk history."""
    reqs = {rid: (r.status.value, r.status_reason,
                  None if r.tokens is None else [int(t) for t in r.tokens])
            for rid, r in eng.requests.items()}
    slo = eng.slo_stats()
    return {"requests": reqs, "faults": dict(eng.fault_stats),
            "slo": {k: slo[k] for k in ("chunks_by_ticks", "chunk_shrinks",
                                        "chunk_grows", "ttft_target_misses",
                                        "tpot_target_misses", "by_priority")},
            "tick": eng.tick}


def both(scenario):
    """Run ``scenario(side) -> engine`` on the JAX and the port side and
    assert the summaries equal.  Returns the port side's engine."""
    jside, tside = models()
    jeng, teng = scenario(jside), scenario(tside)
    js, ts = summary(jeng), summary(teng)
    assert ts["requests"] == js["requests"]
    assert ts == js
    return teng


def solo(eng, req, gen):
    """The port's solo decode of a port-engine request (its own sampling
    params and key)."""
    _, tside = models()
    return serve.solo_decode_for(eng, tside.params, tside.cfg, req, gen,
                                 device="cpu")


def prompts(rng, vocab, lens):
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

_LEVELS = [(1, 2, 4, 8, 16), (1, 3, 9), (2, 4), (16,), (1, 2, 4)]


@settings(max_examples=60, deadline=None)
@given(st.sampled_from(range(len(_LEVELS))),
       st.integers(min_value=1, max_value=3),
       st.integers(min_value=0, max_value=6),
       st.integers(min_value=0, max_value=4),
       st.sampled_from([None, 0, 1, 2, 3, 5, 9, 17, 40]),
       st.sampled_from([None, 1, 2, 3, 6, 11, 30]),
       st.sampled_from([None, 1, 2, 4, 7, 15, 33]))
def test_policy_pick_matches_reference(li, hot, queue, free, slack, headroom,
                                       arrival):
    levels = _LEVELS[li]
    kw = dict(tick=5, queue_depth=queue, free_slots=free,
              min_active_slack=slack, slo_headroom=headroom,
              next_arrival_in=arrival)
    jpol = jserving.AdaptiveChunkPolicy(levels, hot_queue=hot)
    tpol = tserving.AdaptiveChunkPolicy(levels, hot_queue=hot)
    jsig, tsig = jserving.ChunkSignals(**kw), tserving.ChunkSignals(**kw)
    assert tpol.cap(tsig) == jpol.cap(jsig)
    assert tpol.next_ticks(tsig) == jpol.next_ticks(jsig)
    assert tpol.compile_levels == jpol.compile_levels
    assert tpol.next_ticks(tsig) in tpol.compile_levels


def test_policy_validation_and_percentiles_match_reference():
    from repro.serving.slo import percentiles as jpercentiles
    for bad in ((), (0, 2), (-1,)):
        with pytest.raises(ValueError, match="levels"):
            tserving.AdaptiveChunkPolicy(bad)
    with pytest.raises(ValueError, match="hot_queue"):
        tserving.AdaptiveChunkPolicy(hot_queue=0)
    assert tserving.DEFAULT_LEVELS == jserving.DEFAULT_LEVELS
    for xs in ([], [3.0], [1.0, 5.0, 2.0, 8.0, 0.5]):
        assert tserving.percentiles(xs) == jpercentiles(xs)


# ---------------------------------------------------------------------------
# the engine under a policy
# ---------------------------------------------------------------------------

def _slo_trace(side, *, sampled, policy_levels=(1, 2, 4, 8, 16), top=16):
    """Five requests with staggered arrivals, alternating priority classes,
    a TTFT target on class 0 and, with ``sampled``, every other request
    sampled with its own temperature/top-k/top-p."""
    rng = np.random.default_rng(21)
    policy = (side.mod.AdaptiveChunkPolicy(policy_levels)
              if policy_levels else None)
    eng = side.engine(num_slots=2, page_size=4, max_seq_len=24,
                      ticks_per_sync=top, chunk_policy=policy, seed=3)
    sampling = [dict(temperature=0.8, top_k=20, top_p=0.9),
                dict(temperature=1.1), dict(temperature=0.6, top_p=0.7)]
    for i, p in enumerate(prompts(rng, side.cfg.vocab, [5, 9, 7, 6, 8])):
        kw = dict(sampling[i // 2 % 3]) if sampled and i % 2 else {}
        kw["priority"] = i % 2
        if i % 2 == 0:
            kw["ttft_target_ticks"] = 3
        eng.submit(p, 7 + i % 3, arrival=3 * i, **kw)
    eng.run()
    return eng


@pytest.mark.parametrize("sampled", [False, True])
def test_adaptive_engine_matches_reference_engine(sampled):
    eng = both(lambda side: _slo_trace(side, sampled=sampled))
    slo = eng.slo_stats()
    assert slo["adaptive"] == 1 and slo["chunk_shrinks"] >= 1
    assert set(slo["chunks_by_ticks"]) <= set(eng.chunk_policy.compile_levels)
    for rid, req in eng.requests.items():
        assert req.status is tserving.RequestStatus.FINISHED
        np.testing.assert_array_equal(req.tokens, solo(eng, req, req.max_new))
    if sampled:
        assert any(eng.sampling_for(r)[0] > 0 for r in eng.requests.values())


@settings(max_examples=4, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_property_streams_bit_identical_across_policies(seed):
    """Fixed 1, fixed 4 and two adaptive ladders emit the same streams
    (greedy and sampled) on a random trace: chunk boundaries only move
    admission and retirement."""
    _, side = models()
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 6))
    reqs = [(rng.integers(0, side.cfg.vocab, size=int(rng.integers(3, 9)))
             .astype(np.int32), int(rng.integers(2, 8)),
             int(rng.integers(0, 10)), float(rng.choice([0.0, 0.9])),
             int(rng.integers(0, 2))) for _ in range(n)]
    streams = []
    for ticks, levels in ((1, None), (4, None), (8, (1, 2, 4, 8)),
                          (4, (1, 4))):
        policy = tserving.AdaptiveChunkPolicy(levels) if levels else None
        eng = side.engine(num_slots=2, page_size=4, max_seq_len=20,
                          ticks_per_sync=ticks, chunk_policy=policy, seed=seed)
        for p, g, a, t, prio in reqs:
            eng.submit(p, g, arrival=a, temperature=t, top_k=12, priority=prio,
                       ttft_target_ticks=2 if prio == 0 else None)
        done = eng.run()
        streams.append({rid: r.tokens.tolist() for rid, r in done.items()})
    assert all(s == streams[0] for s in streams[1:])


def test_engine_validates_slo_submit_args():
    _, side = models()
    eng = side.engine(num_slots=1, page_size=4, max_seq_len=16)
    p = np.arange(4, dtype=np.int32)
    for kw in (dict(ttft_target_ticks=0), dict(tpot_target_ticks=0),
               dict(deadline_ticks=0)):
        with pytest.raises(ValueError, match=next(iter(kw))):
            eng.submit(p, 2, **kw)
    assert not eng.requests


def test_slo_stats_shape_matches_reference():
    jside, tside = models()
    stats = [_slo_trace(s, sampled=False).slo_stats() for s in (jside, tside)]
    assert stats[1] == stats[0]
    assert set(stats[1]["by_priority"]) == {0, 1}
