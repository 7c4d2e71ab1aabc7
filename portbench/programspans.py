#!/usr/bin/env python3
"""The program's own spans and counters (``repro_torch.tracing``) in a
traced run, and what is read from them.

Every ``run.py --trace 1`` run records them over its window (the serving
meter's ``open_window``/``close_window``; Algorithm 2's ``pruner.run``)
into the run's record under ``"program"``; ``trace.py`` reduces the
device's idle by program span beside the harness's own table, and the
per-layer metrics ``metrics/<name>.py`` that read the spans call the
arithmetic here.  :func:`summary` and :func:`notes` give a traced run's
notes (standard error)::

* spans and counters over the window, by name and per engine step;
* each engine phase's host ms per chunk, and the program's phases
  against the harness's outside meters (``chunk_host_ms``,
  ``knapsack_s``) of the same run;
* each span name's calls, host seconds and the device idle inside its
  own intervals, over the traced span (``trace.own_time``);
* how the program's ``engine.step`` spans pair with the harness's
  ``portbench.engine.step`` spans of the traced span
  (``trace.step_pairing``): on one clock one to one, each program step
  starting a few us after its harness step and ending before it.

As a command it is ``run.py --trace 1`` whose notes also go, with
``--out DIR``, to ``DIR/<cell>-<seed>.json``::

    python3 portbench/programspans.py --workload <cell> --seed <n> --seconds <s> [--out DIR]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench import spec as spec_mod  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402
from portbench.trace import QUEUE  # noqa: E402,F401  (the readers' name for it)

PHASES = ("engine.service", "engine.admit", "engine.prepare", "engine.chunk",
          "engine.commit")


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


# -- a traced run's notes ----------------------------------------------------

def busy_intervals(events) -> List[List[int]]:
    """The merged intervals of the device operations among
    ``(name, start_ns, end_ns, on_device)`` events, as
    ``trace.reduce_events`` counts them (``scripts/span_own_time.py``
    reads them through this)."""
    return trace_mod.merge((s, t) for name, s, t, on_device in events
                           if on_device and not name.startswith("portbench.")
                           and not name.startswith(trace_mod.ANNOTATIONS))


def summary(rec: Dict, events=None) -> Dict:
    """The notes' numbers for one traced run's record.  The own-time
    table and the step pairing are the record's reduced trace's; the
    own-time table is worked out from the traced span's raw ``events``
    where they are given."""
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
    if events is not None:
        out["own_time"] = trace_mod.own_time(spans, busy_intervals(events))
    elif t and "program" in t:
        out["own_time"] = t["program"]
    if t and "step_pairing" in t:
        out["step_pairing"] = t["step_pairing"]
    if t:
        out["idle_s"] = t["window_s"] - t["busy_s"]
    return out


def notes(s: Dict) -> List[str]:
    out = [f"program spans: {s['spans']} over the window, by name {s['by_name']}; "
           f"counters {s['counters']}"]
    for key in ("per_step", "phase_ms_per_chunk", "outside_admit_and_chunk_ms",
                "knapsack_s", "idle_s", "step_pairing", "own_time"):
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
    kept: Dict = {}
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"], keep=kept)
    if args.out is not None and "record" in kept:
        args.out.mkdir(parents=True, exist_ok=True)
        with open(args.out / f"{args.workload}-{args.seed}.json", "w") as f:
            json.dump(summary(kept["record"]), f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
