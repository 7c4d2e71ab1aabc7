#!/usr/bin/env python3
"""A traced run of one cell, as ``portbench/programspans.py`` makes it,
with each program span's own time beside its gap table::

    python3 scripts/span_own_time.py --workload <cell> --seed <n> --seconds <s> [--out DIR]

from the root of a checkout, on the card.  ``programspans.py`` labels
each idle gap of the device by the span around its middle and counts the
gap whole, so a step's host edge swings between labels from run to run.
This adds a note, ``program own_time``, that gives for each span name the
calls and host seconds of its spans over the window, and the device idle
that falls inside its own intervals within the traced span (each gap cut
to them, nested spans of one name counted once).  With ``--out DIR`` the
numbers go to ``DIR/<cell>-<seed>.json`` under ``"own_time"`` too.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import programspans  # noqa: E402


def _merged(intervals) -> List[List[int]]:
    out: List[List[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap_ns(a: List[List[int]], b: List[List[int]]) -> int:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def own_time(spans, events) -> Dict[str, Dict[str, float]]:
    """Per span name (``request.queue``, a wait, left out): calls, host
    seconds over the window, and idle seconds of the traced span inside
    the name's own intervals."""
    busy = programspans.busy_intervals(events)
    gaps = [[a, b] for (_, a), (b, _) in zip(busy, busy[1:])]
    by_name: Dict[str, list] = {}
    for s in spans:
        if s[0] != programspans.QUEUE and s[2] > 0:
            by_name.setdefault(s[0], []).append((s[1], s[2]))
    out = {name: {"calls": len(iv),
                  "host_s": sum(t - s for s, t in iv) / 1e9,
                  "idle_s": _overlap_ns(_merged(iv), gaps) / 1e9}
           for name, iv in by_name.items()}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["idle_s"]))


def main(argv=None) -> int:
    summary, notes = programspans.summary, programspans.notes

    def with_own_time(rec, events=None):
        out = summary(rec, events)
        if events is not None:
            out["own_time"] = own_time(rec["program"]["spans"], events)
        return out

    def with_own_note(s):
        out = notes(s)
        if "own_time" in s:
            out.append(f"program own_time: {s['own_time']}")
        return out

    with mock.patch.object(programspans, "summary", with_own_time), \
            mock.patch.object(programspans, "notes", with_own_note):
        return programspans.main(argv)


if __name__ == "__main__":
    sys.exit(main())
