"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
span of the window that starts at an engine-step boundary and ends at
the window's close, so every kernel of the traced steps is in it and
nothing else.  The profiler is prepared before the window (its start-up
is set-up) and flushed after the close, so neither stalls the window.

:meth:`Trace.reduce` gives the span's wall seconds, the device's busy
seconds (the union of every kernel's and copy's interval), each device
operation's seconds and calls by name, the top ten operations, and the
device's idle gaps summed by what the host was doing then: the
innermost of the harness's own host spans (``record_function`` names
starting ``portbench.``) around the gap's middle.  Given the program's
own spans of the same run (``repro_torch.tracing``, on the same clock),
it also gives each span name's calls, host seconds and the device idle
inside its own intervals within the traced span (:func:`own_time`; a gap
cut to them, nested spans of one name counted once), the ten names with
the most idle (``program_idle``), and how the program's ``engine.step``
spans pair with the harness's ``portbench.engine.step`` spans
(:func:`step_pairing`), which shows whether the two share one clock.
Annotations the profiler shows on the device's timeline (those spans,
and its own ``ProfilerStep#`` ranges) are not device operations.  The raw events are read straight from the
profiler's results: building its per-op tables takes minutes over a
span of a million kernels.  On the CPU (the tests) it records host
events only.
"""
from __future__ import annotations

import bisect
import itertools
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

OUTSIDE = "outside the harness's host spans"
# the profiler's own ranges, which it may also show on the device's
# timeline: annotations, not operations
ANNOTATIONS = ("ProfilerStep#",)
# the program's span of a request's wait in the queue: a wait, not host work
QUEUE = "request.queue"


class Trace:
    def __init__(self, device):
        from torch.profiler import ProfilerAction, ProfilerActivity, profile
        self.device = device
        self.t_start = self.t_stop = None
        phases = [ProfilerAction.WARMUP, ProfilerAction.RECORD_AND_SAVE]
        self.prof = profile(
            activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else []),
            schedule=lambda step: phases[step] if step < 2 else ProfilerAction.NONE)
        t0 = time.perf_counter()
        self.prof.start()                      # prepares, records nothing yet
        self.costs = {"prepare_s": time.perf_counter() - t0}

    @property
    def running(self) -> bool:
        return self.t_start is not None and self.t_stop is None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.step()                       # records from here
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t_stop = time.perf_counter()
        self.prof.step()                       # stops recording and collects
        self.prof.stop()
        self.costs["stop_s"] = time.perf_counter() - self.t_stop

    def reduce(self, spans: Optional[Sequence] = None) -> Dict:
        """The traced span's numbers; with the program's ``spans``, its
        idle by program span too."""
        from torch.autograd import DeviceType
        t0 = time.perf_counter()
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.device_type() == DeviceType.CUDA)
                  for e in self.prof.profiler.kineto_results.events()]
        out = reduce_events(events, self.t_stop - self.t_start, spans)
        self.costs.update(reduce_s=time.perf_counter() - t0, events=len(events))
        out["costs"] = self.costs
        return out


def reduce_events(events, window_s: float, spans: Optional[Sequence] = None) -> Dict:
    """The span's numbers from ``(name, start_ns, end_ns, on_device)``
    events: busy seconds (the union of the device operations), seconds
    and calls by operation, the top ten, and the idle gaps by host span;
    with the program's ``spans`` (``(name, start_ns, end_ns, ...)``),
    :func:`own_time` over the traced span (from the first event to the
    last) under ``program``, its ten names with the most idle under
    ``program_idle``, and :func:`step_pairing` under ``step_pairing``."""
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for name, start, end, on_device in events:
        if name.startswith("portbench."):           # the harness's own spans
            if not on_device:
                host.append((start, end, name[len("portbench."):]))
        elif on_device and not name.startswith(ANNOTATIONS):
            dev.append((start, end, name))
    ops: Dict[str, List[float]] = {}
    for s, t, name in dev:
        row = ops.setdefault(name, [0.0, 0])
        row[0] += (t - s) / 1e9
        row[1] += 1
    merged = merge((s, t) for s, t, _ in dev)
    busy_s = sum(t - s for s, t in merged) / 1e9
    gaps = _attribute_gaps(merged, host)
    edges = max(0.0, window_s - busy_s - sum(gaps.values()))
    if edges > 0:
        gaps["before the first or after the last device op"] = edges
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    out = {
        "window_s": window_s, "busy_s": busy_s,
        "ops": {k: {"seconds": v[0], "calls": v[1]} for k, v in ops.items()},
        "breakdown": {
            "device_ops": [[k[:200], v[0]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }
    if spans is not None:
        bounds = (min((e[1] for e in events), default=0),
                  max((e[2] for e in events), default=0))
        own = own_time(spans, merged, bounds)
        out["program"] = own
        out["program_idle"] = [[k, v["idle_s"]] for k, v in list(own.items())[:10]]
        out["step_pairing"] = step_pairing(events, spans)
    return out


def step_pairing(events, spans) -> Dict:
    """The harness's ``portbench.engine.step`` host spans against the
    program's ``engine.step`` spans: each harness span paired with the
    program span that starts nearest, the counts, whether the pairing is
    one to one, and the offsets in us (program start less harness start,
    the median and largest absolute ones; harness end less program end).
    On one clock each program step lies inside its harness step, so both
    medians are small and not negative."""
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
    return {"harness": len(outer), "program": len(inner), "paired": len(used),
            "one_to_one": len(used) == len(outer),
            "median_abs_us": statistics.median(ab), "max_abs_us": max(ab),
            "median_us": statistics.median(offs),
            "median_end_us": statistics.median(ends), "min_end_us": min(ends)}


def merge(intervals) -> List[List[int]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out: List[List[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def overlap_ns(a: List[List[int]], b: List[List[int]]) -> int:
    """Length of the intersection of two sorted, merged interval lists."""
    return _overlap(a, _index(b))


def _index(b: List[List[int]]):
    """Starts, ends and the lengths summed before each of sorted, merged
    intervals ``b``, for :func:`_overlap`."""
    return ([s for s, _ in b], [t for _, t in b],
            [0, *itertools.accumulate(t - s for s, t in b)])


def _overlap(a: List[List[int]], index) -> int:
    """Length of the intersection of intervals ``a`` with the indexed
    ones, found by bisection for each interval of ``a``."""
    starts, ends, before = index
    total = 0
    for lo, hi in a:
        i = bisect.bisect_right(ends, lo)         # the first that ends past lo
        j = bisect.bisect_left(starts, hi)        # the first that starts at hi or on
        if i < j:
            total += (before[j] - before[i] - max(0, lo - starts[i])
                      - max(0, ends[j - 1] - hi))
    return total


def own_time(spans, busy: List[List[int]],
             bounds: Optional[Tuple[int, int]] = None) -> Dict[str, Dict[str, float]]:
    """Per program span name (``request.queue``, a wait, left out, and
    spans never closed): calls, host seconds, and the device idle of the
    traced span inside the name's own intervals, between the merged busy
    intervals ``busy``; most idle first.  With ``bounds`` (the traced
    span's first and last ns), each span is cut to them and one outside
    them is left out, so calls, host and idle seconds cover one window."""
    gaps = _index([[a, b] for (_, a), (b, _) in zip(busy, busy[1:])])
    by_name: Dict[str, list] = {}
    for s in spans:
        if s[0] == QUEUE or s[2] <= 0:
            continue
        start, end = s[1], s[2]
        if bounds is not None:
            start, end = max(start, bounds[0]), min(end, bounds[1])
            if end < start:
                continue
        by_name.setdefault(s[0], []).append((start, end))
    out = {name: {"calls": len(iv),
                  "host_s": sum(t - s for s, t in iv) / 1e9,
                  "idle_s": _overlap(merge(iv), gaps) / 1e9}
           for name, iv in by_name.items()}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["idle_s"]))


def _attribute_gaps(merged, host) -> Dict[str, float]:
    """Seconds of device idle between merged busy intervals, by the
    innermost host span (the shortest one) around each gap's middle."""
    spans = sorted(host)
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        label, width = OUTSIDE, None
        i = bisect.bisect_right(starts, mid)
        for s, t, name in reversed(spans[max(0, i - 64):i]):
            if s <= mid <= t and (width is None or t - s < width):
                label, width = name, t - s
        out[label] = out.get(label, 0.0) + (b - a) / 1e9
    return out


def kernel_seconds(reduced: Dict, fragment: str) -> Tuple[float, int]:
    """Summed seconds and calls of the device operations whose name holds
    ``fragment``."""
    s, n = 0.0, 0
    for name, row in reduced["ops"].items():
        if fragment in name:
            s += row["seconds"]
            n += row["calls"]
    return s, n
