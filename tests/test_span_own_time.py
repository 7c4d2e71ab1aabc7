"""``scripts/span_own_time.py``: the device idle inside each program
span's own intervals, on a synthetic run."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "span_own_time", ROOT / "scripts" / "span_own_time.py")
sot = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sot)


def _span(name, s, t, parent=-1):
    return (name, s, t, parent, -1, -1)


def test_idle_is_cut_to_each_span_and_nested_spans_count_once():
    spans = [_span("engine.step", 0, 100),
             _span("prefix.verify", 4, 12, 0),
             _span("prefix.evict", 30, 50, 0),
             _span("prefix.evict", 40, 45, 0),         # nested in the one above
             _span("request.queue", 0, 100),           # a wait: left out
             _span("engine.chunk", 90, -1, 0)]         # never closed
    # busy 0-5, 10-20, 44-60, 95-99: gaps 5-10, 20-44, 60-95
    events = [("k", 0, 5, True), ("k", 10, 20, True), ("k", 44, 60, True),
              ("k", 95, 99, True), ("portbench.engine.step", 0, 100, False)]
    out = sot.own_time(spans, events)
    assert out == {
        "engine.step": {"calls": 1, "host_s": pytest.approx(100e-9),
                        "idle_s": pytest.approx(64e-9)},
        "prefix.evict": {"calls": 2, "host_s": pytest.approx(25e-9),
                         "idle_s": pytest.approx(14e-9)},
        "prefix.verify": {"calls": 1, "host_s": pytest.approx(8e-9),
                          "idle_s": pytest.approx(5e-9)}}
    assert list(out) == ["engine.step", "prefix.evict", "prefix.verify"]


def test_the_interval_overlap():
    assert sot._merged([(5, 9), (0, 3), (2, 4), (9, 10)]) == [[0, 4], [5, 10]]
    assert sot._overlap_ns([[0, 4], [5, 10]], [[3, 6], [8, 20]]) == 4
    assert sot._overlap_ns([], [[0, 1]]) == 0
