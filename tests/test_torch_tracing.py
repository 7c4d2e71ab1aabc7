"""The port's span-and-counter recorder (``repro_torch.tracing``) and the
spans the engine, the pruner and the graphed train step put in it.

Off, a span is one shared object and nothing is recorded; on, spans
nest by a stack of open spans, keep their request id and argument, and
``drain`` hands everything over once.  A small CPU engine with tracing
on splits each step into its five phases, records each admitted
request's wait from ``submit`` to its admission, and verifies as many
prefix-index entries as the index holds; its streams are the same with
tracing on and off.  ``IterativePruner.run`` gives one
``pruner.iteration`` per iteration with its four phases.  On the card
(``cuda``-marked, skipped here) the graphed train step counts the bytes
it copies and the engine's graph replays split into upload, launch and
wait.
"""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config, make_smoke
from repro_torch.core import (
    BlockingSpec,
    IterativePruner,
    PruneConfig,
    TPUResourceModel,
    apply_masks,
    build_structures,
    constant_step,
)
from repro_torch.core.masks import map_tree, tree_leaves
from repro_torch.core.structures import iter_leaves
from repro_torch.launch import serve
from repro_torch.optim import AdamWConfig, constant_lr
from repro_torch.serving import ServingEngine
from repro_torch.sparse import DEFAULT_EXCLUDE, DEFAULT_INCLUDE
from repro_torch.train import GraphedTrainStep, init_train_state, make_train_body

KW = dict(num_slots=3, page_size=4, max_seq_len=32)
PHASES = ["engine.service", "engine.admit", "engine.prepare", "engine.chunk",
          "engine.commit"]


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """Every test starts and ends with the tracer off and empty."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()
    torch.set_num_threads(prev)


def _children(spans, i):
    return [s[0] for s in spans if s[3] == i]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_off_is_one_shared_object_and_records_nothing():
    a, b = tracing.span("x"), tracing.span("y", rid=3, arg=1)
    assert a is b
    with a as sp:
        sp.set_arg(5)
        tracing.count("c", 7)
        tracing.add("q", 1, 2)
    assert not tracing.enabled()
    assert tracing.drain() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("drain_twice", [False, True])
def test_on_records_parents_ids_args_and_counters(drain_twice):
    tracing.enable()
    with tracing.span("outer", arg="chunk") as outer:
        with tracing.span("inner", rid=4):
            tracing.count("c", 2)
        with tracing.span("second") as sp:
            sp.set_arg(9)
            tracing.count("c", 3)
        tracing.add("queue", 10, outer.start, rid=4)
    tracing.count("d")
    with tracing.span("top"):
        pass
    rec = tracing.drain()
    names = [s[0] for s in rec["spans"]]
    assert names == ["outer", "inner", "second", "queue", "top"]
    outer_row, inner, second, queue, top = rec["spans"]
    assert outer_row[3] == -1 and outer_row[5] == "chunk"
    assert inner[3] == 0 and inner[4] == 4 and inner[5] == -1
    assert second[3] == 0 and second[5] == 9
    assert queue == ("queue", 10, outer_row[1], -1, 4, -1)
    assert top[3] == -1
    for s in (outer_row, inner, second, top):
        assert 0 < s[1] <= s[2]
    assert outer_row[1] <= inner[1] and inner[2] <= second[1] <= second[2] <= outer_row[2]
    assert rec["counters"] == {"c": 5, "d": 1}
    if drain_twice:
        assert tracing.drain() == {"spans": [], "counters": {}}
    tracing.disable()
    with tracing.span("after"):
        tracing.count("c")
    assert tracing.drain() == {"spans": [], "counters": {}}


def test_a_span_open_across_a_drain_is_not_listed_again():
    tracing.enable()
    with tracing.span("open"):
        rec = tracing.drain()
        with tracing.span("next"):
            pass
    assert rec["spans"][0][0] == "open" and rec["spans"][0][2] == 0
    spans = tracing.drain()["spans"]
    assert [(s[0], s[3]) for s in spans] == [("next", -1)]


def test_a_span_closes_on_an_exception():
    tracing.enable()
    with pytest.raises(KeyError):
        with tracing.span("outer"):
            with tracing.span("raises"):
                raise KeyError("x")
    with tracing.span("after"):
        pass
    spans = tracing.drain()["spans"]
    assert [(s[0], s[3]) for s in spans] == [("outer", -1), ("raises", 0), ("after", -1)]
    assert all(s[2] >= s[1] > 0 for s in spans)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_PARAMS = {}


def _engine(**kw):
    if not _PARAMS:
        cfg = make_smoke(get_config("qwen1.5-0.5b"))
        _PARAMS["qwen"] = (cfg, serve.build_params(cfg, seed=0, device="cpu")[0])
    cfg, params = _PARAMS["qwen"]
    return ServingEngine(params, cfg, device="cpu", **dict(KW, **kw))


def _prompts(vocab, n=6):
    """Prompts behind a shared 8-token head (two pages), so later ones
    hit the prefix cache, of lengths 9-14."""
    rng = np.random.default_rng(4)
    head = rng.integers(0, vocab, 8)
    return [np.concatenate([head, rng.integers(0, vocab, 1 + i)]).astype(np.int32)
            for i in range(n)]


def _submit(eng, prompts, sampled=False):
    for i, p in enumerate(prompts):
        kw = {"temperature": 0.8, "top_k": 20} if sampled and i % 2 else {}
        eng.submit(p, 4 + i % 3, arrival=eng.tick, **kw)


def test_engine_steps_split_into_their_phases():
    eng = _engine()
    prompts = _prompts(eng.cfg.vocab)
    tracing.enable()
    _submit(eng, prompts)
    steps, verified = [], []
    while eng.scheduler.pending or any(s is not None for s in eng.slots):
        entries = len(eng.prefix_index)
        eng.step()
        rec = tracing.drain()
        steps.append(rec)
        verified.append((rec["counters"]["prefix.entries_verified"], entries))
    eng.step()                                   # nothing left: no chunk
    idle = tracing.drain()
    assert all(got == want for got, want in verified)
    assert any(want > 0 for _, want in verified)
    queued, admitted, scanned = {}, {}, 0
    for rec in steps:
        spans = rec["spans"]
        tops = [i for i, s in enumerate(spans) if s[0] == "engine.step"]
        assert len(tops) == 1 and spans[tops[0]][3] == -1
        step = spans[tops[0]]
        assert _children(spans, tops[0]) == PHASES
        assert 1 <= step[5] <= eng.num_slots          # the chunk's rows
        for i, s in enumerate(spans):
            assert s[1] <= s[2]
            if s[3] >= 0:                         # inside its parent
                p = spans[s[3]]
                assert p[1] <= s[1] and s[2] <= p[2]
            if s[0] == "request.queue":
                assert s[3] == -1 and s[4] not in queued
                queued[s[4]] = s
            elif s[0] == "request.admit":
                assert spans[s[3]][0] == "engine.admit"
                admitted[s[4]] = s
                kids = _children(spans, i)
                assert kids[0] == "prefix.match" and kids[-1] == "prefix.insert"
                assert "graphs.run" in kids
            elif s[0] == "prefix.verify":
                assert spans[s[3]][0] == "engine.service"
            elif s[0] == "scheduler.admit":
                assert spans[s[3]][0] == "engine.admit"
        scanned += rec["counters"].get("scheduler.waiting_scanned", 0)
    assert sorted(admitted) == sorted(queued) == list(range(len(prompts)))
    for rid, a in admitted.items():
        assert queued[rid][2] == a[1] and queued[rid][1] <= a[1]
    assert scanned > 0
    tops = [i for i, s in enumerate(idle["spans"]) if s[0] == "engine.step"]
    assert len(tops) == 1
    assert _children(idle["spans"], tops[0]) == PHASES[:2]
    assert eng.prefix_stats["hit_requests"] > 0


def test_requests_submitted_while_off_record_no_queue_span():
    eng = _engine()
    prompts = _prompts(eng.cfg.vocab, 2)
    _submit(eng, prompts[:1])
    tracing.enable()
    _submit(eng, prompts[1:])
    eng.run()
    names = [(s[0], s[4]) for s in tracing.drain()["spans"]]
    assert [n for n in names if n[0] == "request.queue"] == [("request.queue", 1)]
    assert {n for n in names if n[0] == "request.admit"} == {
        ("request.admit", 0), ("request.admit", 1)}


@pytest.mark.parametrize("sampled", [False, True])
def test_streams_are_the_same_with_tracing_on_and_off(sampled):
    out = {}
    for on in (False, True):
        if on:
            tracing.enable()
        eng = _engine()
        _submit(eng, _prompts(eng.cfg.vocab), sampled=sampled)
        done = eng.run()
        out[on] = {rid: r.tokens.tolist() for rid, r in done.items()}
        tracing.disable()
    assert out[True] == out[False]
    assert tracing.drain()["spans"]


# ---------------------------------------------------------------------------
# the pruner
# ---------------------------------------------------------------------------

def test_pruner_iterations_split_into_their_phases():
    cfg = make_smoke(get_config("qwen1.5-0.5b"))
    params = serve.build_params(cfg, seed=1, device="cpu")[0]
    structs = build_structures(params, BlockingSpec(32, 32), include=DEFAULT_INCLUDE,
                               exclude=DEFAULT_EXCLUDE, min_size=1024)
    pr = IterativePruner(structs, TPUResourceModel(), PruneConfig(
        schedule=constant_step([0.3, 0.3], 0.1), tolerance=10.0,
        higher_is_better=False))

    def finetune(p, m):
        return map_tree(lambda x: x * 0.97, apply_masks(p, m))

    def evaluate(p, m):
        return float(sum(t.abs().sum() for t in tree_leaves(apply_masks(p, m))))

    tracing.enable()
    _, _, logs = pr.run(params, finetune, evaluate)
    spans = tracing.drain()["spans"]
    iters = [i for i, s in enumerate(spans) if s[0] == "pruner.iteration"]
    assert len(iters) == len(logs) == 3
    assert [spans[i][5] for i in iters] == [0, 1, 2]
    for i in iters:
        assert spans[i][3] == -1
        assert _children(spans, i) == ["pruner.knapsack", "pruner.finetune",
                                       "pruner.eval", "pruner.report"]
        k = next(j for j, s in enumerate(spans) if s[3] == i)
        assert _children(spans, k) == ["pruner.values", "pruner.solve", "pruner.masks"]
    evals = [s for s in spans if s[0] == "pruner.eval"]
    assert len(evals) == 4 and evals[0][3] == -1      # the baseline's first


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


def _nbytes(tree):
    return sum(t.nbytes for _, t in iter_leaves(tree))


@pytest.mark.cuda
def test_graphed_train_step_counts_its_copies(card):
    """One ``train.step`` a call: the first captures, later ones copy in,
    replay and copy out; ``train.copy_bytes`` adds the state and batch
    copied in and the state (masks aside) and metrics cloned out."""
    cfg = make_smoke(get_config("qwen1.5-0.5b"))
    params = serve.build_params(cfg, seed=0, device=card)[0]
    masks = map_tree(torch.ones_like, params)
    st = init_train_state(params, AdamWConfig(), masks=masks)
    step = GraphedTrainStep(make_train_body(cfg, AdamWConfig(), constant_lr(1e-3)),
                            card)
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randint(0, cfg.vocab, (2, 17), generator=gen, device=card,
                      dtype=torch.int64).to(torch.int32)
    batch = {"tokens": x[:, :-1].contiguous(), "labels": x[:, 1:].contiguous()}
    tracing.enable()
    for _ in range(3):
        st, metrics = step(st, batch)
    torch.cuda.synchronize()
    rec = tracing.drain()
    spans = rec["spans"]
    steps = [i for i, s in enumerate(spans) if s[0] == "train.step"]
    assert len(steps) == 3
    assert _children(spans, steps[0]) == ["graphs.capture"]
    for i in steps[1:]:
        assert _children(spans, i) == ["train.copy_in", "train.replay",
                                       "train.copy_out"]
    per_call = (2 * _nbytes(st) + _nbytes(batch) - _nbytes(masks)
                + _nbytes(metrics))
    assert rec["counters"]["train.copy_bytes"] == 3 * per_call


@pytest.mark.cuda
def test_graph_replays_split_into_upload_launch_and_wait(card):
    """A graphed engine's third pass over the same prompts captures
    nothing: each ``graphs.run`` (a chunk's or an admission's) is an
    upload, a launch and a wait; the first pass's captures show as
    ``graphs.capture`` inside their ``graphs.run``."""
    cfg = make_smoke(get_config("qwen1.5-0.5b"), head_dim=64)
    params = serve.build_params(cfg, seed=0, device=card)[0]
    eng = ServingEngine(params, cfg, device=card, **KW)
    prompts = _prompts(cfg.vocab)
    tracing.enable()
    passes = []
    for _ in range(3):
        _submit(eng, prompts)
        eng.run()
        passes.append(tracing.drain()["spans"])
    runs = [i for i, s in enumerate(passes[0]) if s[0] == "graphs.run"]
    assert any(_children(passes[0], i) == ["graphs.capture"] for i in runs)
    spans = passes[2]
    runs = [i for i, s in enumerate(spans) if s[0] == "graphs.run"]
    assert {spans[i][5] for i in runs} == {"admission", "decode_chunk"}
    for i in runs:
        assert _children(spans, i) == ["graphs.upload", "graphs.launch",
                                       "graphs.wait"]
        parent = spans[spans[i][3]][0]
        assert parent == ("request.admit" if spans[i][5] == "admission"
                          else "engine.chunk")
