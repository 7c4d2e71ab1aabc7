#!/usr/bin/env python3
"""A traced run of one cell with the program's own spans and counters
(``repro_torch.tracing``) recorded over the window::

    python3 portbench/programspans.py --workload <cell> --seed <n> --seconds <s> [--out DIR]

from the root of a checkout, on the card.  It is ``run.py --trace 1``
with the program's tracer turned on at the window's open and drained at
its close (the serving meter's ``open_window``/``close_window``;
Algorithm 2's ``IterativePruner.run``), the drained spans and counters
put into the run's record under ``"program"``, and the metrics of
:data:`METRICS` read from them beside the cell's own per-layer metrics.
Its notes (standard error) add:

* the device's idle gaps of the traced span by the innermost program
  span around each gap's middle (``request.queue``, a wait rather than
  host work, left out), beside the harness's own table;
* how the program's ``engine.step`` spans pair with the harness's
  ``portbench.engine.step`` spans (count and start offsets);
* idle in ``engine.step`` outside its five phases, or outside every
  program span, as a share of the idle seconds;
* the program's phases against the harness's outside meters
  (``chunk_host_ms``, ``knapsack_s``) of the same run;
* spans and counters per window step.

With ``--out DIR`` the notes' numbers also go to
``DIR/<cell>-<seed>.json``.  The hooks are attached from outside, so the
harness's files stay as they are; :func:`hooked` is the same wiring for
the CPU tests.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench import program  # noqa: E402
from portbench import spec as spec_mod  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402

OUTSIDE = "outside every program span"
QUEUE = "request.queue"
PHASES = ("engine.service", "engine.admit", "engine.prepare", "engine.chunk",
          "engine.commit")
_ENGINE = "engine: serving/engine.py"

# the per-layer metrics read from the program's spans and counters, as
# BENCHMARK.json's "per_layer" entries would hold them
METRICS: List[Dict] = [
    {"name": "queue_wait_ms.chat", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": _ENGINE, "moves": "ttft_p95_ms",
     "workloads": ["qwen-chat"]},
    {"name": "service_host_ms.chat", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": _ENGINE, "moves": "tpot_p95_ms",
     "workloads": ["qwen-chat"]},
    {"name": "service_host_ms.backlog", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": _ENGINE, "moves": "serve_tok_s",
     "workloads": ["granite-backlog"]},
    {"name": "commit_host_ms.backlog", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": _ENGINE, "moves": "serve_tok_s",
     "workloads": ["granite-backlog"]},
    {"name": "verify_entries.chat", "unit": "entries", "better": "lower",
     "source": "program_counter", "layer": _ENGINE, "moves": "tpot_p95_ms",
     "workloads": ["qwen-chat"]},
    {"name": "eval_s.prune", "unit": "s", "better": "lower",
     "source": "host_clock", "layer": "pruner: core/pruner.py and core/knapsack.py",
     "moves": "train_tok_s", "workloads": ["qwen-prune"]},
    {"name": "train_copy_gb.prune", "unit": "GB", "better": "lower",
     "source": "program_counter", "layer": "train step: train/graphs.py",
     "moves": "train_tok_s", "workloads": ["qwen-prune"]},
]


# -- the readers' arithmetic -----------------------------------------------

def _spans(rec: Dict, name: str) -> List[Tuple]:
    p = rec.get("program")
    return [] if p is None else [s for s in p["spans"] if s[0] == name]


def _ms(spans) -> float:
    return sum(s[2] - s[1] for s in spans) / 1e6


def per_step_ms(rec: Dict, name: str, per: str) -> Optional[float]:
    """Host ms of the window's ``name`` spans per ``per`` span."""
    n = len(_spans(rec, per))
    return _ms(_spans(rec, name)) / n if n else None


def queue_wait_ms(rec: Dict) -> Optional[float]:
    """Mean ms from ``submit`` to admission over the window's admitted
    requests that were submitted inside it."""
    q = _spans(rec, QUEUE)
    return _ms(q) / len(q) if q else None


def counter_per(rec: Dict, counter: str, per: str) -> Optional[float]:
    """Counter ``counter`` of the window per ``per`` span."""
    p, n = rec.get("program"), len(_spans(rec, per))
    if p is None or not n or counter not in p["counters"]:
        return None
    return p["counters"][counter] / n


def mean_s(rec: Dict, name: str) -> Optional[float]:
    """Mean seconds of the window's ``name`` spans."""
    s = _spans(rec, name)
    return _ms(s) / 1e3 / len(s) if s else None


def train_copy_gb(rec: Dict) -> Optional[float]:
    """GB (1e9 bytes) the graphed train step copies in and out a call."""
    v = counter_per(rec, "train.copy_bytes", "train.step")
    return None if v is None else v / 1e9


# -- the idle gaps by program span -------------------------------------------

def busy_intervals(events) -> List[List[int]]:
    """The merged intervals of the device operations among
    ``(name, start_ns, end_ns, on_device)`` events, as
    ``trace.reduce_events`` counts them."""
    dev = sorted((s, t) for name, s, t, on_device in events
                 if on_device and not name.startswith("portbench.")
                 and not name.startswith(trace_mod.ANNOTATIONS))
    merged: List[List[int]] = []
    for s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def innermost(spans, at: int, starts=None) -> Optional[int]:
    """Index of the innermost closed span (``request.queue`` aside)
    around instant ``at``: the last one started by then, or the first of
    its parents that still holds it.  ``starts``: the sorted
    ``(start, index)`` of those spans, when called many times."""
    if starts is None:
        starts = sorted((s[1], i) for i, s in enumerate(spans)
                        if s[0] != QUEUE and s[2] > 0)
    j = bisect.bisect_right(starts, (at, len(spans))) - 1
    i = starts[j][1] if j >= 0 else -1
    while i >= 0 and not spans[i][1] <= at <= spans[i][2]:
        i = spans[i][3]
    return i if i >= 0 else None


def program_gaps(events, spans, window_s: float) -> Dict[str, float]:
    """Seconds of device idle between the traced span's busy intervals,
    by the innermost program span around each gap's middle; the rest of
    the window (before the first and after the last operation) apart."""
    merged = busy_intervals(events)
    starts = sorted((s[1], i) for i, s in enumerate(spans)
                    if s[0] != QUEUE and s[2] > 0)
    out: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        i = innermost(spans, (a + b) // 2, starts)
        label = OUTSIDE if i is None else spans[i][0]
        out[label] = out.get(label, 0.0) + (b - a) / 1e9
    busy = sum(t - s for s, t in merged) / 1e9
    edges = window_s - busy - sum(out.values())
    if edges > 0:
        out["before the first or after the last device op"] = edges
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def step_offsets(events, spans) -> Dict:
    """The harness's ``portbench.engine.step`` host spans against the
    program's ``engine.step`` spans: each harness span paired with the
    program span that starts nearest, whether the pairing is one to
    one, and the offsets in us (program start less harness start, the
    median and largest absolute ones; harness end less program end):
    on one clock both are small and not negative."""
    outer = sorted((s, t) for name, s, t, on_device in events
                   if name == "portbench.engine.step" and not on_device)
    inner = sorted((s[1], s[2]) for s in spans if s[0] == "engine.step")
    if not outer or not inner:
        return {"harness": len(outer), "program": len(inner)}
    starts = [s for s, _ in inner]
    offs, ends, used = [], [], set()
    for s, t in outer:
        j = bisect.bisect_left(starts, s)
        near = min((k for k in (j - 1, j) if 0 <= k < len(inner)),
                   key=lambda k: abs(starts[k] - s))
        used.add(near)
        offs.append((starts[near] - s) / 1e3)
        ends.append((t - inner[near][1]) / 1e3)
    ab = [abs(o) for o in offs]
    return {"harness": len(outer), "paired": len(used),
            "one_to_one": len(used) == len(outer),
            "median_abs_us": statistics.median(ab), "max_abs_us": max(ab),
            "median_us": statistics.median(offs),
            "median_end_us": statistics.median(ends), "min_end_us": min(ends)}


def summary(rec: Dict, events=None) -> Dict:
    """The notes' numbers for one run's record (and its trace's raw
    events, where the run was traced)."""
    p = rec["program"]
    spans = p["spans"]
    steps = len(_spans(rec, "engine.step"))
    chunks = len(_spans(rec, "engine.chunk"))
    names: Dict[str, int] = {}
    for s in spans:
        names[s[0]] = names.get(s[0], 0) + 1
    out = {"spans": len(spans), "by_name": names, "counters": p["counters"]}
    if steps:
        out["per_step"] = {"steps": steps, "chunks": chunks,
                           "spans": len(spans) / steps,
                           "step_ms": per_step_ms(rec, "engine.step", "engine.step"),
                           **{k: v / steps for k, v in p["counters"].items()}}
        out["phase_ms_per_chunk"] = {
            ph: per_step_ms(rec, ph, "engine.chunk") for ph in PHASES}
        host = rec.get("host") or {}
        if chunks and host.get("chunk_host_ms") is not None:
            out["outside_admit_and_chunk_ms"] = {
                "program": sum(out["phase_ms_per_chunk"][ph] for ph in
                               ("engine.service", "engine.prepare", "engine.commit")),
                "meter": host["chunk_host_ms"]}
    if rec.get("knapsack_s"):
        out["knapsack_s"] = {"program": mean_s(rec, "pruner.knapsack"),
                             "meter": sum(rec["knapsack_s"]) / len(rec["knapsack_s"])}
    t = rec.get("trace")
    if events is not None and t:
        gaps = program_gaps(events, spans, t["window_s"])
        idle = t["window_s"] - t["busy_s"]
        edge = gaps.get("before the first or after the last device op", 0.0)
        out["idle_gaps"] = gaps
        out["idle_s"] = idle
        out["uncovered_share"] = {
            "engine.step outside its phases": gaps.get("engine.step", 0.0) / idle,
            OUTSIDE: gaps.get(OUTSIDE, 0.0) / max(idle - edge, 1e-12)}
        out["step_offsets"] = step_offsets(events, spans)
    return out


# -- the wiring ----------------------------------------------------------------

@contextlib.contextmanager
def hooked():
    """Inside the block, a cell's driver run (through ``spec.driver``)
    records the program's spans and counters over its window into
    ``record["program"]``, adds :func:`summary`'s notes, and the cell's
    per-layer metrics include those of :data:`METRICS` that list it."""
    from unittest import mock

    program.import_port()
    from repro_torch import tracing
    from repro_torch.core.pruner import IterativePruner

    from portbench import serving
    state: Dict = {}
    open_window, close_window = serving.Meter.open_window, serving.Meter.close_window
    pruner_run, reduce_events = IterativePruner.run, trace_mod.reduce_events
    driver, load_cell = spec_mod.driver, spec_mod.load_cell

    def begin():
        tracing.drain()
        tracing.enable()

    def end():
        tracing.disable()
        state["program"] = tracing.drain()

    def traced_open(meter):
        open_window(meter)
        begin()

    def traced_close(meter):
        end()
        close_window(meter)

    def traced_pruner_run(pruner, *a, **kw):
        begin()
        try:
            return pruner_run(pruner, *a, **kw)
        finally:
            end()

    def keep_events(events, window_s):
        state["events"] = events
        return reduce_events(events, window_s)

    def traced_driver(name):
        mod = driver(name)
        inner = mod.run

        def run(*a, **kw):
            out = inner(*a, **kw)
            rec = out["record"]
            rec["program"] = state.pop("program")
            state["summary"] = summary(rec, state.pop("events", None))
            out["notes"].extend(notes(state["summary"]))
            return out

        mod.run = run
        return mod

    def with_metrics(name, *a, **kw):
        cell = load_cell(name, *a, **kw)
        cell["per_layer"] = cell["per_layer"] + [
            m for m in METRICS if name in m["workloads"]]
        return cell

    with contextlib.ExitStack() as stack:
        for obj, attr, new in ((serving.Meter, "open_window", traced_open),
                               (serving.Meter, "close_window", traced_close),
                               (IterativePruner, "run", traced_pruner_run),
                               (trace_mod, "reduce_events", keep_events),
                               (spec_mod, "driver", traced_driver),
                               (spec_mod, "load_cell", with_metrics)):
            stack.enter_context(mock.patch.object(obj, attr, new))
        try:
            yield state
        finally:
            tracing.disable()
            tracing.drain()


def notes(s: Dict) -> List[str]:
    out = [f"program spans: {s['spans']} over the window, by name {s['by_name']}; "
           f"counters {s['counters']}"]
    for key in ("per_step", "phase_ms_per_chunk", "outside_admit_and_chunk_ms",
                "knapsack_s", "idle_gaps", "uncovered_share", "step_offsets"):
        if key in s:
            out.append(f"program {key}: {s[key]}")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    run = spec_mod.load_module(HERE / "run.py", "portbench_run_entry")
    with hooked() as state:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    if args.out is not None and "summary" in state:
        args.out.mkdir(parents=True, exist_ok=True)
        with open(args.out / f"{args.workload}-{args.seed}.json", "w") as f:
            json.dump(state["summary"], f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
