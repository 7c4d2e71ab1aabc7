"""CUDA graphs of the port's compiled steps — the counterpart of the
reference's jit caches (one XLA program per static argument set) and of
``analysis/runtime.py``'s ``CompileTracker`` / ``cache_size``.

:func:`capture` is the one capture recipe: the step runs once eagerly on
a side stream (that run is the call's result, and it warms up what must
not happen during a capture: the kernels' shared-memory opt-in, cluster
launches, library handles), then the same step is captured into a graph
of the caller's memory pool.  A capture launches nothing, so the
launches the kernel wrappers counted during it are taken back and kept
on the graph (``_build.recorded_launches``) and added at each replay
(``_build.add_launches``).  The fixed-batch launcher captures its
prefill and its whole ``lm_generate`` with it.

A :class:`PackedGraphs` holds the graphs of one engine function from ONE
packed int32 input vector to ONE packed int32 output block, one graph
per static variant: the decode chunk per ``(ticks, sampled)`` and the
admission prefill per ``(L, start, guard)``.  A graph replays over the
engine's own page pools, recurrent state rows (Mamba, mLSTM, sLSTM) and
params, which are updated in place and so keep their storage.  A
variant's static input is a view, as long as that variant's packed
input, of one device buffer as long as the longest.  A replay is

1. one host-to-device copy of a pinned buffer (reused from call to call)
   into the graph's static input,
2. ``CUDAGraph.replay()``,
3. one device-to-host copy of the packed outputs into a pinned buffer,
   then a wait on the stream — the call's one declared transfer, inside
   ``analysis.runtime.sync_region(region)`` (the decode chunk's or the
   admission's; an optional ``within`` callable runs in that same
   region).

Steps 1–3 run under ``torch.cuda.set_sync_debug_mode("error")``: a
hidden host sync inside a replay raises.  A capture is the counterpart
of a compile: it counts in ``analysis.runtime.compile_events`` and runs
inside the call's declared region (its warm-up result is the call's
transfer), and ``_cache_size`` gives the captured variants to
``analysis.runtime.cache_size``.  All graphs of an engine share one
memory pool: they never run concurrently, and each replay's outputs are
copied out before the next replay.

Any failure to capture or replay raises :class:`GraphFailure`; the
engine never falls back to the eager step on its own.  The cyclic
garbage collector does not run during a capture (see ``_no_cyclic_gc``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.analysis import runtime as analysis_runtime
from repro_torch.kernels import _build

__all__ = ["Captured", "GraphFailure", "PackedGraphs", "capture",
           "pool_reserved_bytes"]


class GraphFailure(RuntimeError):
    """A CUDA graph of a compiled step failed to capture or replay."""


@contextlib.contextmanager
def _sync_debug_error():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def _no_cyclic_gc():
    """No collection of garbage cycles during the block: a ``CUDAGraph``
    freed by the collector while another stream captures (a dropped
    engine's graphs sit in a cycle through its bound step function)
    resets its graph in the middle of that capture, and CUDA then
    invalidates the capture.  Such garbage is collected after the
    capture.  (``torch.cuda.graph`` no longer collects on entry unless
    ``force_cudagraph_gc`` is set; a full collection before each capture
    cost ~0.24 s, two thirds of a prefill's capture, on the H100's host.)"""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@dataclasses.dataclass
class Captured:
    """One captured graph: its static outputs, the kernel launches of
    one replay, the capture's seconds (warm-up run included) and their
    split (``warm_up``, ``record``, ``sync``)."""
    graph: torch.cuda.CUDAGraph
    out: Any
    launches: Dict[str, int]
    capture_seconds: float
    split: Dict[str, float] = dataclasses.field(default_factory=dict)
    replays: int = 0

    def replay(self) -> Any:
        """Replay the graph (asynchronously) and count its launches;
        returns the static outputs."""
        self.graph.replay()
        self.replays += 1
        _build.add_launches(self.launches)
        return self.out


def capture(fn: Callable[[], Any], device: torch.device, pool,
            what: str) -> Tuple[Any, Captured]:
    """Run ``fn()`` once on a side stream, then capture ``fn()`` into a
    graph of ``pool``.  Returns (the eager run's result, the graph).
    The current stream waits for the eager run.  Raises
    :class:`GraphFailure`."""
    with tracing.span("graphs.capture"):
        return _capture_graph(fn, device, pool, what)


def _capture_graph(fn, device, pool, what):
    t = [time.perf_counter()]
    analysis_runtime.count_compile()
    try:
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            first = fn()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t.append(time.perf_counter())
        with _no_cyclic_gc(), _build.recorded_launches() as launches:
            with torch.cuda.graph(graph, pool=pool):
                out = fn()
            t.append(time.perf_counter())
        torch.cuda.synchronize(device)
        t.append(time.perf_counter())
    except RuntimeError as err:
        raise GraphFailure(f"capture of {what} failed: {err}") from err
    split = dict(zip(("warm_up", "record", "sync"),
                     (b - a for a, b in zip(t, t[1:]))))
    return first, Captured(graph=graph, out=out, launches=launches,
                           capture_seconds=t[-1] - t[0], split=split)


def pool_reserved_bytes(pool, device: torch.device) -> Optional[int]:
    """Bytes the caching allocator holds in segments of graph memory
    pool ``pool`` (from ``torch.cuda.memory_snapshot``); None where the
    snapshot does not name segments' pools."""
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device") != device.index and device.index is not None:
            continue
        if "segment_pool_id" not in seg:
            return None
        named = True
        if tuple(seg["segment_pool_id"]) == tuple(pool):
            total += int(seg["total_size"])
    return total if named else 0


@dataclasses.dataclass
class _Variant:
    graph: Captured
    n_in: int                       # length of the packed input
    host_out: torch.Tensor          # pinned


class PackedGraphs:
    """The captured variants of one engine function
    ``fn(packed_in, *variant) -> packed_out`` (packed int32 in and out),
    one graph per ``variant`` (a tuple of Python values).  ``n_max`` is
    the longest packed input; ``region`` the declared sync region of a
    call; ``label(variant)`` names a variant in :meth:`stats`; ``pool``
    the engine's graph memory pool (default: a new one)."""

    def __init__(self, fn: Callable[..., torch.Tensor], n_max: int,
                 device: torch.device, *, region: str,
                 label: Callable[[Tuple], str], pool=None):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.fn, self.device, self.region, self.label = fn, device, region, label
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        self.static_in = torch.zeros((n_max,), dtype=torch.int32, device=device)
        self.host_in = torch.zeros((n_max,), dtype=torch.int32, pin_memory=True)
        self.graphs: Dict[Tuple, _Variant] = {}

    def __call__(self, packed_in: np.ndarray, *variant) -> np.ndarray:
        """Run one call; returns its packed outputs on the host."""
        return self.run(packed_in, tuple(variant))[0]

    def run(self, packed_in: np.ndarray, variant: Tuple,
            within: Optional[Callable[[], Any]] = None) -> Tuple[np.ndarray, Any]:
        """Run variant ``variant`` on ``packed_in``; ``within()`` runs in
        the declared region after the transfer.  Returns (packed outputs
        on the host, what ``within`` returned or None)."""
        with tracing.span("graphs.run", arg=self.region):
            return self._run(packed_in, variant, within)

    def _run(self, packed_in, variant, within):
        n = len(packed_in)
        self.host_in.numpy()[:n] = packed_in
        g = self.graphs.get(variant)
        if g is None:
            return self._capture(variant, n, within)
        if n != g.n_in:
            raise GraphFailure(f"{self.region} variant {variant} was captured "
                               f"over {g.n_in} inputs, called with {n}")
        stream = torch.cuda.current_stream(self.device)
        try:
            with _sync_debug_error():
                with tracing.span("graphs.upload"):
                    self.static_in[:n].copy_(self.host_in[:n],
                                             non_blocking=True)
                with tracing.span("graphs.launch"):
                    g.graph.replay()
            with analysis_runtime.sync_region(self.region), \
                    tracing.span("graphs.wait"):
                with _sync_debug_error():
                    g.host_out.copy_(g.graph.out, non_blocking=True)
                stream.synchronize()
                extra = within() if within is not None else None
        except RuntimeError as err:
            raise GraphFailure(f"replay of {self.region} {variant} failed: "
                               f"{err}") from err
        return g.host_out.numpy().copy(), extra

    def _capture(self, variant: Tuple, n: int,
                 within: Optional[Callable[[], Any]]) -> Tuple[np.ndarray, Any]:
        with analysis_runtime.sync_region(self.region):
            try:
                self.static_in[:n].copy_(self.host_in[:n])
            except RuntimeError as err:
                raise GraphFailure(f"capture of {self.region} {variant} "
                                   f"failed: {err}") from err
            static = self.static_in[:n]
            first, graph = capture(lambda: self.fn(static, *variant),
                                   self.device, self.pool,
                                   f"{self.region} {variant}")
            host = first.cpu().numpy()
            self.graphs[variant] = _Variant(
                graph=graph, n_in=n,
                host_out=torch.empty(graph.out.shape, dtype=graph.out.dtype,
                                     pin_memory=True))
            return host, within() if within is not None else None

    def _cache_size(self) -> int:
        """Captured variants (read by ``analysis.runtime.cache_size``)."""
        return len(self.graphs)

    def stats(self) -> Dict[str, object]:
        """Captured variants (named by ``label``), each one's capture
        seconds (warm-up run included), their split summed over the
        variants, replays and kernel launches per replay."""
        rows = {self.label(v): g.graph for v, g in sorted(self.graphs.items())}
        return {
            "captures": len(rows),
            "variants": list(rows),
            "capture_seconds": {k: g.capture_seconds for k, g in rows.items()},
            "capture_split": {part: sum(g.split.get(part, 0.0)
                                        for g in rows.values())
                              for part in ("warm_up", "record", "sync")},
            "replays": {k: g.replays for k, g in rows.items()},
            "launches_per_replay": {k: dict(g.launches) for k, g in rows.items()},
        }
