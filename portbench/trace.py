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
starting ``portbench.``) around the gap's middle.  Annotations the
profiler shows on the device's timeline (those spans, and its own
``ProfilerStep#`` ranges) are not device operations.  The raw events are
read straight from the profiler's results: building its per-op tables
takes minutes over a span of a million kernels.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

OUTSIDE = "outside the harness's host spans"
# the profiler's own ranges, which it may also show on the device's
# timeline: annotations, not operations
ANNOTATIONS = ("ProfilerStep#",)


class Trace:
    def __init__(self, device):
        from torch.profiler import ProfilerAction, ProfilerActivity, profile
        self.device = device
        self.t_start = self.t_stop = None
        phases = [ProfilerAction.WARMUP, ProfilerAction.RECORD_AND_SAVE]
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=lambda step: phases[step] if step < 2 else ProfilerAction.NONE)
        t0 = time.perf_counter()
        self.prof.start()                      # prepares, records nothing yet
        self.costs = {"prepare_s": time.perf_counter() - t0}

    @property
    def running(self) -> bool:
        return self.t_start is not None and self.t_stop is None

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        self.prof.step()                       # records from here
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        self.prof.step()                       # stops recording and collects
        self.prof.stop()
        self.costs["stop_s"] = time.perf_counter() - self.t_stop

    def reduce(self) -> Dict:
        from torch.autograd import DeviceType
        t0 = time.perf_counter()
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.device_type() == DeviceType.CUDA)
                  for e in self.prof.profiler.kineto_results.events()]
        out = reduce_events(events, self.t_stop - self.t_start)
        self.costs.update(reduce_s=time.perf_counter() - t0, events=len(events))
        out["costs"] = self.costs
        return out


def reduce_events(events, window_s: float) -> Dict:
    """The span's numbers from ``(name, start_ns, end_ns, on_device)``
    events: busy seconds (the union of the device operations), seconds
    and calls by operation, the top ten, and the idle gaps by host span."""
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
    dev.sort()
    merged: List[List[int]] = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_s = sum(t - s for s, t in merged) / 1e9
    gaps = _attribute_gaps(merged, host)
    edges = max(0.0, window_s - busy_s - sum(gaps.values()))
    if edges > 0:
        gaps["before the first or after the last device op"] = edges
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": window_s, "busy_s": busy_s,
        "ops": {k: {"seconds": v[0], "calls": v[1]} for k, v in ops.items()},
        "breakdown": {
            "device_ops": [[k[:200], v[0]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


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
