"""One CUDA graph per decode-chunk variant — the port's counterpart of
the reference's jit cache of ``_decode_chunk`` (one XLA program per
static ``(ticks, sampled)``) and of ``analysis/runtime.py``'s
``CompileTracker`` / ``cache_size``.

A :class:`ChunkGraphs` belongs to one engine: a graph replays over the
engine's own page pools, recurrent state rows (Mamba, mLSTM, sLSTM) and
params, which are updated in place and so keep their storage: the
captured decode steps advance the rows with ``copy_`` into the same
tensors, and an admission writes a slot's row between replays.  The chunk function takes ONE packed int32 input
buffer (every host-mirrored slot vector, floats and keys by their bits)
and returns ONE packed int32 output block, so a replay is

1. one host-to-device copy of a pinned buffer into the graph's static
   input,
2. ``CUDAGraph.replay()``,
3. one device-to-host copy of the packed outputs into a pinned buffer,
   then a wait on the stream — the chunk's one declared transfer, inside
   ``analysis.runtime.sync_region("decode_chunk")``.

Steps 1–3 run under ``torch.cuda.set_sync_debug_mode("error")``: a
hidden host sync inside a replay raises.  A capture is the counterpart
of a compile: it counts in ``analysis.runtime.compile_events`` and runs
inside the chunk's declared region (its warm-up result is the chunk's
transfer), and ``_cache_size`` gives the captured variants to
``analysis.runtime.cache_size``.

The first call of a variant captures it, as PyTorch's graph recipe
does: the chunk runs once eagerly on a side stream (that run is the
call's result, and it warms up what must not happen during a capture:
the kernels' shared-memory opt-in, cluster launches, library handles),
then the same function is captured over the static input.  A capture
launches nothing, so the launches the kernel wrappers counted during it
are taken back and kept on the variant (``_build.recorded_launches``)
and added at each replay (``_build.add_launches``).  All graphs of an
engine share one memory pool: they never run concurrently, and each
replay's outputs are copied out before the next replay.

Any failure to capture or replay raises :class:`GraphFailure`; the
engine never falls back to the eager chunk on its own.  The cyclic
garbage collector runs just before a capture and not during it (see
``_no_cyclic_gc``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.analysis import runtime as analysis_runtime
from repro_torch.kernels import _build

__all__ = ["ChunkGraphs", "GraphFailure"]

Variant = Tuple[int, bool]          # (ticks, sampled)


class GraphFailure(RuntimeError):
    """A CUDA graph of a decode chunk failed to capture or replay."""


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
    """Collect garbage cycles now and none during the block: a
    ``CUDAGraph`` freed by the collector while another stream captures
    (a dropped engine's graphs sit in a cycle through its bound chunk
    function) resets its graph in the middle of that capture, and CUDA
    then invalidates the capture.  ``torch.cuda.graph`` no longer
    collects on entry unless ``force_cudagraph_gc`` is set."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor               # the capture's packed outputs (static)
    host_out: torch.Tensor          # pinned
    launches: Dict[str, int]        # kernel launches of one replay
    capture_seconds: float
    replays: int = 0


class ChunkGraphs:
    """The captured variants of one engine's decode chunk.

    ``fn(packed_in, ticks, sampled) -> packed_out`` is the chunk as it
    runs eagerly; ``n_in`` the length of the packed int32 input."""

    def __init__(self, fn: Callable[[torch.Tensor, int, bool], torch.Tensor],
                 n_in: int, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.fn, self.device = fn, device
        self.pool = torch.cuda.graph_pool_handle()
        self.static_in = torch.zeros((n_in,), dtype=torch.int32, device=device)
        self.host_in = torch.zeros((n_in,), dtype=torch.int32, pin_memory=True)
        self.graphs: Dict[Variant, _Graph] = {}

    def __call__(self, packed_in: np.ndarray, ticks: int,
                 sampled: bool) -> np.ndarray:
        """Run one chunk; returns its packed outputs on the host."""
        self.host_in.numpy()[:] = packed_in
        variant = (int(ticks), bool(sampled))
        g = self.graphs.get(variant)
        if g is None:
            return self._capture(variant)
        stream = torch.cuda.current_stream(self.device)
        try:
            with _sync_debug_error():
                self.static_in.copy_(self.host_in, non_blocking=True)
                g.graph.replay()
            with analysis_runtime.sync_region("decode_chunk"):
                with _sync_debug_error():
                    g.host_out.copy_(g.out, non_blocking=True)
                stream.synchronize()
        except RuntimeError as err:
            raise GraphFailure(f"replay of decode chunk {variant} failed: "
                               f"{err}") from err
        g.replays += 1
        _build.add_launches(g.launches)
        return g.host_out.numpy().copy()

    def _capture(self, variant: Variant) -> np.ndarray:
        with analysis_runtime.sync_region("decode_chunk"):
            return self._capture_in_region(variant)

    def _capture_in_region(self, variant: Variant) -> np.ndarray:
        ticks, sampled = variant
        t0 = time.perf_counter()
        analysis_runtime.count_compile()
        try:
            self.static_in.copy_(self.host_in)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                first = self.fn(self.static_in, ticks, sampled)   # warm-up = result
            torch.cuda.current_stream(self.device).wait_stream(side)
            host = first.cpu().numpy()
            graph = torch.cuda.CUDAGraph()
            with _no_cyclic_gc(), _build.recorded_launches() as launches:
                with torch.cuda.graph(graph, pool=self.pool):
                    out = self.fn(self.static_in, ticks, sampled)
            torch.cuda.synchronize(self.device)
        except RuntimeError as err:
            raise GraphFailure(f"capture of decode chunk {variant} failed: "
                               f"{err}") from err
        self.graphs[variant] = _Graph(
            graph=graph, out=out,
            host_out=torch.empty(out.shape, dtype=out.dtype, pin_memory=True),
            launches=launches,
            capture_seconds=time.perf_counter() - t0)
        return host

    def _cache_size(self) -> int:
        """Captured variants (read by ``analysis.runtime.cache_size``)."""
        return len(self.graphs)

    def stats(self) -> Dict[str, object]:
        """Captured variants (``"<ticks>/greedy|sampled"``), each one's
        capture seconds (warm-up run included), replays and kernel
        launches per replay."""
        rows = {f"{t}/{'sampled' if s else 'greedy'}": g
                for (t, s), g in sorted(self.graphs.items())}
        return {
            "captures": len(rows),
            "variants": list(rows),
            "capture_seconds": {k: g.capture_seconds for k, g in rows.items()},
            "replays": {k: g.replays for k, g in rows.items()},
            "launches_per_replay": {k: dict(g.launches) for k, g in rows.items()},
        }
