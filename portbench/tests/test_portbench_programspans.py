"""The program's spans in a cell's run (``portbench/programspans.py``):
the readers and the idle-gap table by program span on synthetic
records and events, the harness's own reduction pinned as it was, the
metrics' entries against the contract, and a whole smoke-size run of
each cell with the program's tracer hooked in, every new metric reading
a number."""
import json

import pytest
import torch

import smoke
from portbench import programspans as ps
from portbench import spec as spec_mod
from portbench import trace as trace_mod

SECONDS = {"qwen-chat": 2.0, "granite-backlog": 1.5, "qwen-prune": 2.0}
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
    ]
    return {"program": {"spans": spans, "counters": {"prefix.entries_verified": 30}}}


def test_readers_on_a_synthetic_record():
    rec = _record()
    assert ps.queue_wait_ms(rec) == pytest.approx(16e-6)
    assert ps.per_step_ms(rec, "engine.service", "engine.step") == pytest.approx(15e-6)
    assert ps.per_step_ms(rec, "engine.commit", "engine.chunk") == pytest.approx(8e-6)
    assert ps.counter_per(rec, "prefix.entries_verified", "engine.step") == 15
    for name in ("queue_wait_ms.chat", "service_host_ms.chat", "verify_entries.chat",
                 "service_host_ms.backlog", "commit_host_ms.backlog"):
        assert spec_mod.metric_reader(name).read(rec) is not None, name
    prune = {"program": {"spans": [_span("pruner.eval", 0, 2 * S),
                                   _span("train.step", 0, 10),
                                   _span("train.step", 10, 20),
                                   _span("pruner.eval", 3 * S, 4 * S)],
                         "counters": {"train.copy_bytes": 5 * S}}}
    assert spec_mod.metric_reader("eval_s.prune").read(prune) == pytest.approx(1.5)
    assert spec_mod.metric_reader("train_copy_gb.prune").read(prune) == pytest.approx(2.5)
    # a run without the program's record reads nothing, and raises nothing
    for m in ps.METRICS:
        assert spec_mod.metric_reader(m["name"]).read({"trace": None}) is None


def test_idle_gaps_go_to_the_innermost_program_span():
    rec = _record()
    spans = rec["program"]["spans"]
    # busy 0-5 (engine.service), 14-20 (request.admit), 60-88 (engine.chunk),
    # 95-96 (commit), 125-126 (admit of step 2, under request.queue 11)
    events = [("k", 0, 5, True), ("k", 14, 20, True), ("k", 60, 88, True),
              ("k", 95, 96, True), ("k", 125, 126, True),
              ("portbench.engine.step", 0, 100, True),       # an annotation
              ("ProfilerStep#3", 0, 200, True)]
    gaps = ps.program_gaps(events, spans, 200e-9)
    # gaps: 5-14 mid 9 service; 20-60 mid 40 boundary admit/prepare (admit's
    # end and prepare's start share 40: the later-started prepare holds it);
    # 88-95 mid 91 commit; 96-125 mid 110 service of step 2
    assert gaps == {"engine.service": pytest.approx(38e-9),
                    "engine.prepare": pytest.approx(40e-9),
                    "engine.commit": pytest.approx(7e-9),
                    "before the first or after the last device op": pytest.approx(
                        200e-9 - 41e-9 - 85e-9)}
    assert ps.innermost(spans, 99) == 0                  # step, outside its phases
    assert ps.innermost(spans, 150) is None
    assert ps.innermost(spans, 3) == 1                   # not the queue span
    assert ps.busy_intervals(events) == [[0, 5], [14, 20], [60, 88], [95, 96],
                                         [125, 126]]


def test_step_offsets_pair_each_harness_step_with_the_nearest():
    spans = [_span("engine.step", 1000 + 3000 * k + 2, 1000 + 3000 * k + 2900)
             for k in range(5)]
    events = [("portbench.engine.step", 1000 + 3000 * k, 1000 + 3000 * k + 2950, False)
              for k in range(2, 5)]
    events.append(("portbench.engine.step", 7000, 9950, True))    # device copy
    out = ps.step_offsets(events, spans)
    assert out["harness"] == out["paired"] == 3 and out["one_to_one"]
    assert out["median_abs_us"] == pytest.approx(2e-3)
    assert out["median_end_us"] == out["min_end_us"] == pytest.approx(50e-3)


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
    layers = {m["layer"] for m in bench["per_layer"]}
    names = {m["name"] for m in bench["per_layer"]}
    for m in ps.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["name"] not in names and m["layer"] in layers
        assert m["source"] in ("host_clock", "program_counter")
        for cell in m["workloads"]:
            e2e = {x["name"] for x in spec_mod.metrics_of(bench, cell, "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)
        assert (spec_mod.HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_a_smoke_run_with_the_program_traced_reads_every_new_metric(cell):
    spec = smoke.cell(cell)
    spec["limits"] = ({"loss_gap": 0.005, "grad_gap": 0.002, "change_gap": 0.01}
                      if cell == "qwen-prune" else {"served_gap": 0.02})
    with ps.hooked() as state:
        drv = spec_mod.driver(spec["traffic"]["driver"])
        out = drv.run(spec, 2**31 + 11, SECONDS[cell], False, torch.device("cpu"))
    assert out["correct"], out["checks"]
    rec = out["record"]
    wanted = [m["name"] for m in ps.METRICS if cell in m["workloads"]]
    assert wanted
    for name in wanted:
        v = spec_mod.metric_reader(name).read(rec)
        if name in CARD_ONLY:
            assert v is None, name
        else:
            assert v is not None and v >= 0, name
    got = {s[0] for s in rec["program"]["spans"]}
    if cell == "qwen-prune":
        assert {"pruner.iteration", "pruner.knapsack", "pruner.finetune",
                "pruner.eval", "pruner.report", "train.init_state"} <= got
        assert state["summary"]["knapsack_s"]["program"] >= \
            state["summary"]["knapsack_s"]["meter"] > 0
    else:
        assert set(ps.PHASES) <= got and "engine.step" in got
        assert state["summary"]["per_step"]["steps"] > 0
    assert any(n.startswith("program spans:") for n in out["notes"])
    # the hooks are gone after the block
    from portbench import serving
    assert serving.Meter.open_window.__qualname__ == "Meter.open_window"
    assert spec_mod.driver.__module__ == "portbench.spec"
