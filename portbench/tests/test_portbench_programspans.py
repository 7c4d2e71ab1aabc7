"""The program's spans in a cell's traced run: the readers, the device's
idle by program span (each span's own intervals) on synthetic records
and events, the harness's own reduction pinned as it was, the metrics'
entries in ``BENCHMARK.json`` against the contract, and a whole
smoke-size traced run of each cell, every metric that reads the program
reading a number, beside an untraced one in which the program's tracer
never turns on."""
import json

import pytest
import torch

import smoke
from portbench import program
from portbench import programspans as ps
from portbench import spec as spec_mod
from portbench import trace as trace_mod

SECONDS = {"qwen-chat": 2.0, "granite-backlog": 1.5, "qwen-prune": 2.0}
# the per-layer metrics read from the program's spans and counters
PROGRAM_METRICS = ("queue_wait_ms.chat", "service_host_ms.chat",
                   "service_host_ms.backlog", "commit_host_ms.backlog",
                   "verify_host_ms.chat", "eval_s.prune", "train_copy_gb.prune")
# on the CPU the fine-tune's step is the eager one: it copies nothing
CARD_ONLY = {"train_copy_gb.prune"}
S = 10**9


def _span(name, start, end, parent=-1, rid=-1, arg=-1):
    return (name, start, end, parent, rid, arg)


def _record():
    """Two engine steps (the second without a chunk) and three requests'
    waits, two of them admitted."""
    spans = [
        _span("engine.step", 0, 100, arg=2),          # 0
        _span("engine.service", 0, 10, 0),            # 1
        _span("engine.admit", 10, 40, 0),             # 2
        _span("request.admit", 12, 38, 2, rid=7),     # 3
        _span("engine.prepare", 40, 50, 0),           # 4
        _span("engine.chunk", 50, 90, 0),             # 5
        _span("engine.commit", 90, 98, 0),            # 6
        _span("request.queue", 2, 12, rid=7),         # 7
        _span("engine.step", 100, 130),               # 8
        _span("engine.service", 100, 120, 8),         # 9
        _span("engine.admit", 120, 130, 8),           # 10
        _span("request.queue", 104, 126, rid=8),      # 11
        _span("prefix.verify", 2, 8, 1),              # 12
        _span("prefix.verify", 102, 106, 9),          # 13
    ]
    return {"program": {"spans": spans, "counters": {"prefix.entries_verified": 30}}}


def test_readers_on_a_synthetic_record():
    rec = _record()
    assert ps.queue_wait_ms(rec) == pytest.approx(16e-6)
    assert ps.per_step_ms(rec, "engine.service", "engine.step") == pytest.approx(15e-6)
    assert ps.per_step_ms(rec, "engine.commit", "engine.chunk") == pytest.approx(8e-6)
    assert ps.counter_per(rec, "prefix.entries_verified", "engine.step") == 15
    assert spec_mod.metric_reader("verify_host_ms.chat").read(rec) == pytest.approx(5e-6)
    for name in ("queue_wait_ms.chat", "service_host_ms.chat", "verify_host_ms.chat",
                 "service_host_ms.backlog", "commit_host_ms.backlog"):
        assert spec_mod.metric_reader(name).read(rec) is not None, name
    prune = {"program": {"spans": [_span("pruner.eval", 0, 2 * S),
                                   _span("train.step", 0, 10),
                                   _span("train.step", 10, 20),
                                   _span("pruner.eval", 3 * S, 4 * S)],
                         "counters": {"train.copy_bytes": 5 * S}}}
    assert spec_mod.metric_reader("eval_s.prune").read(prune) == pytest.approx(1.5)
    assert spec_mod.metric_reader("train_copy_gb.prune").read(prune) == pytest.approx(2.5)
    # an untraced run's record (no program) reads nothing, and raises nothing
    for name in PROGRAM_METRICS:
        assert spec_mod.metric_reader(name).read({"trace": None, "program": None}) is None


def test_idle_is_cut_to_each_span_and_nested_spans_count_once():
    spans = [_span("engine.step", 0, 100),
             _span("prefix.verify", 4, 12, 0),
             _span("prefix.evict", 30, 50, 0),
             _span("prefix.evict", 40, 45, 0),         # nested in the one above
             _span("request.queue", 0, 100),           # a wait: left out
             _span("engine.chunk", 90, -1, 0)]         # never closed
    # busy 0-5, 10-20, 44-60, 95-99: gaps 5-10, 20-44, 60-95
    events = [("k", 0, 5, True), ("k", 10, 20, True), ("k", 44, 60, True),
              ("k", 95, 99, True), ("portbench.engine.step", 0, 100, False),
              ("portbench.engine.step", 0, 100, True),        # an annotation
              ("ProfilerStep#3", 0, 200, True)]
    want = {"engine.step": {"calls": 1, "host_s": pytest.approx(100e-9),
                            "idle_s": pytest.approx(64e-9)},
            "prefix.evict": {"calls": 2, "host_s": pytest.approx(25e-9),
                             "idle_s": pytest.approx(14e-9)},
            "prefix.verify": {"calls": 1, "host_s": pytest.approx(8e-9),
                              "idle_s": pytest.approx(5e-9)}}
    out = trace_mod.reduce_events(events, 200e-9, spans)
    assert out["program"] == want
    assert list(out["program"]) == ["engine.step", "prefix.evict", "prefix.verify"]
    assert out["program_idle"] == [["engine.step", pytest.approx(64e-9)],
                                   ["prefix.evict", pytest.approx(14e-9)],
                                   ["prefix.verify", pytest.approx(5e-9)]]
    # the breakdown keeps its form beside it
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the notes' table is the reduced trace's, or the raw events'
    rec = {"program": {"spans": spans, "counters": {}}, "trace": out}
    assert ps.summary(rec)["own_time"] == want
    assert ps.summary(rec, events)["own_time"] == want
    assert ps.busy_intervals(events) == [[0, 5], [10, 20], [44, 60], [95, 99]]


def test_own_time_covers_the_traced_span_only():
    spans = [_span("engine.step", 0, 100),           # cut to 50-100
             _span("engine.step", 100, 200),         # inside
             _span("prefix.verify", 10, 20),         # before the span: left out
             _span("prefix.verify", 140, 150)]
    busy = [[50, 60], [90, 120], [160, 200]]
    out = trace_mod.own_time(spans, busy, (50, 200))
    assert out == {"engine.step": {"calls": 2, "host_s": pytest.approx(150e-9),
                                   "idle_s": pytest.approx(70e-9)},
                   "prefix.verify": {"calls": 1, "host_s": pytest.approx(10e-9),
                                     "idle_s": pytest.approx(10e-9)}}
    # without bounds every span counts whole
    assert trace_mod.own_time(spans, busy)["engine.step"]["host_s"] == pytest.approx(200e-9)


def _steps(starts, start, end, shift=0):
    return [_span("engine.step", s + start + shift, s + end + shift) for s in starts]


STEP_STARTS = [1000 + 3000 * k for k in range(5)]


@pytest.mark.parametrize("shift, median_us, median_end_us", [
    (0, 2e-3, 50e-3),                    # one clock: each inside its harness step
    (-1500, -1.498, 1.55),               # the program's clock 1.5 us behind: starts before
])
def test_step_pairing_pairs_each_harness_step_with_the_nearest(
        shift, median_us, median_end_us):
    spans = _steps(STEP_STARTS, 2, 2900, shift)
    events = [("portbench.engine.step", s, s + 2950, False) for s in STEP_STARTS[2:]]
    events.append(("portbench.engine.step", 7000, 9950, True))    # device copy
    out = trace_mod.step_pairing(events, spans)
    assert out["harness"] == 3 and out["program"] == 5
    assert out["paired"] == 3 and out["one_to_one"]
    assert out["median_us"] == pytest.approx(median_us)
    assert out["median_end_us"] == pytest.approx(median_end_us)
    assert trace_mod.step_pairing(events, []) == {"harness": 3, "program": 0}
    # it rides on the reduced trace and into the notes
    red = trace_mod.reduce_events(events, 1e-5, spans)
    assert red["step_pairing"] == out
    rec = {"program": {"spans": spans, "counters": {}}, "trace": red}
    assert any(n.startswith("program step_pairing:") for n in ps.notes(ps.summary(rec)))


@pytest.mark.parametrize("a, b, want", [
    ([[0, 4], [5, 10]], [[3, 6], [8, 20]], 4),
    ([], [[0, 1]], 0),
    ([[0, 1]], [], 0),
    ([[2, 3]], [[0, 10]], 1),                          # inside one interval
    ([[0, 10]], [[1, 2], [4, 6], [9, 12]], 4),         # over several
    ([[0, 5], [6, 8]], [[5, 6]], 0),                   # touching only
])
def test_the_interval_overlap(a, b, want):
    assert trace_mod.overlap_ns(a, b) == want == trace_mod.overlap_ns(b, a)


def test_intervals_merge():
    assert trace_mod.merge([(5, 9), (0, 3), (2, 4), (9, 10)]) == [[0, 4], [5, 10]]
    assert trace_mod.merge([]) == []


def test_the_harness_reduction_is_as_it_was():
    """``reduce_events`` byte for byte on the harness's own test events."""
    events = [
        ("ProfilerStep#1", 0, 4 * S, True),
        ("portbench.engine.step", 0, 4 * S, False),
        ("portbench.engine.step", 0, 4 * S, True),
        ("portbench.engine._admit", int(1.5 * S), int(2.5 * S), False),
        ("kernel_a", 0, 1 * S, True),
        ("kernel_b", int(0.5 * S), int(1.5 * S), True),
        ("kernel_a", 3 * S, 4 * S, True),
        ("aten::mm", 0, 4 * S, False),
    ]
    ops = ('"ops": {"kernel_a": {"calls": 2, "seconds": 2.0}, '
           '"kernel_b": {"calls": 1, "seconds": 1.0}}')
    top = '"device_ops": [["kernel_a", 2.0], ["kernel_b", 1.0]]'
    assert json.dumps(trace_mod.reduce_events(events, 4.0), sort_keys=True) == (
        '{"breakdown": {' + top + ', "idle_gaps": [["engine._admit", 1.5]]}, '
        '"busy_s": 2.5, ' + ops + ', "window_s": 4.0}')
    assert json.dumps(trace_mod.reduce_events(events, 5.0), sort_keys=True) == (
        '{"breakdown": {' + top + ', "idle_gaps": [["engine._admit", 1.5], '
        '["before the first or after the last device op", 1.0]]}, '
        '"busy_s": 2.5, ' + ops + ', "window_s": 5.0}')


def test_the_metrics_entries_keep_the_contract():
    bench = spec_mod.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    # appended after every entry that was there before them
    assert [m["name"] for m in bench["per_layer"][-len(PROGRAM_METRICS):]] == \
        list(PROGRAM_METRICS)
    layers = {m["layer"] for m in bench["per_layer"][:-len(PROGRAM_METRICS)]}
    for name in PROGRAM_METRICS:
        m = entries[name]
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["layer"] in layers
        assert m["source"] in ("program_span", "program_counter")
        for cell in m["workloads"]:
            e2e = {x["name"] for x in spec_mod.metrics_of(bench, cell, "end_to_end")}
            assert m["moves"] in e2e, (name, cell)
        assert (spec_mod.HERE / "metrics" / f"{name}.py").exists()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, trace):
    spec = smoke.cell(cell)
    spec["traffic"]["trace_from"] = 0.0     # the whole window: a slow step can't skip it
    spec["limits"] = ({"loss_gap": 0.005, "grad_gap": 0.002, "change_gap": 0.01}
                      if cell == "qwen-prune" else {"served_gap": 0.02})
    drv = spec_mod.driver(spec["traffic"]["driver"])
    return spec, drv.run(spec, 2**31 + 11, SECONDS[cell], trace, torch.device("cpu"))


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_a_traced_smoke_run_reads_every_program_metric(cell):
    spec, out = _run(cell, True)
    assert out["correct"], out["checks"]
    rec = out["record"]
    wanted = [m["name"] for m in spec["per_layer"] if m["name"] in PROGRAM_METRICS]
    assert wanted
    for name in wanted:
        v = spec_mod.metric_reader(name).read(rec)
        if name in CARD_ONLY:
            assert v is None, name
        else:
            assert v is not None and v >= 0, name
    got = {s[0] for s in rec["program"]["spans"]}
    s = ps.summary(rec)
    if cell == "qwen-prune":
        assert {"pruner.iteration", "pruner.knapsack", "pruner.finetune",
                "pruner.eval", "pruner.report", "train.init_state"} <= got
        assert s["knapsack_s"]["program"] >= s["knapsack_s"]["meter"] > 0
    else:
        assert set(ps.PHASES) <= got and "engine.step" in got
        assert s["per_step"]["steps"] > 0
        # the program's steps and the harness's share one clock
        pairing = s["step_pairing"]
        assert pairing["one_to_one"] and pairing["paired"] == pairing["harness"] > 0
        assert pairing["median_us"] >= 0 and pairing["median_end_us"] >= 0
    # the program's idle table rides on the reduced trace, beside the breakdown
    assert set(rec["trace"]["program"]) <= got
    assert len(rec["trace"]["program_idle"]) == min(10, len(rec["trace"]["program"]))
    assert ps.notes(s)[0].startswith("program spans:")
    from repro_torch import tracing
    assert not tracing.enabled()


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_an_untraced_smoke_run_never_turns_the_programs_tracer_on(cell, monkeypatch):
    program.import_port()
    from repro_torch import tracing

    def refuse():
        raise AssertionError("the program's tracer was turned on in an untraced run")

    monkeypatch.setattr(tracing, "enable", refuse)
    _, out = _run(cell, False)
    assert out["correct"], out["checks"]
    assert out["record"]["program"] is None and out["record"]["trace"] is None
