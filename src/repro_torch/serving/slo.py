"""SLO-aware adaptive chunk scheduling — host-side copy of the
reference's ``src/repro/serving/slo.py`` for the torch port.

The engine only admits, retires and services lifecycle events at chunk
boundaries, so a fixed ``ticks_per_sync`` leaves a freed slot idle for
up to ``ticks_per_sync - 1`` ticks and quantizes a waiting request's
time to first token to the chunk grid.  This module makes the chunk
length a *policy* decided at every boundary from host-mirrored state
alone:

* **queue hot** — arrived waiters exist: cap the chunk at the minimum
  remaining token budget over active rows (the earliest tick a slot can
  free);
* **SLO pressure** — a hard ``deadline_ticks``, a soft per-token target
  (``tpot_target_ticks``) or a waiter's soft ``ttft_target_ticks`` is
  close: cap the chunk at the headroom;
* **scheduled arrival inside the chunk** — cap the chunk to land a
  boundary at the next arrival (or at the next slot-free event when no
  slot is free);
* **calm** — run the largest chunk.

The cap is rounded DOWN to the policy's declared ``levels`` ladder.

**The capture contract.**  On the card each distinct chunk length is
one captured CUDA graph of the engine's ``_decode_chunk`` (per sampled
or greedy variant), as each is one XLA compile in the reference.  The
policy therefore only ever returns members of the frozen ``levels``
tuple (plus the degraded-mode 1), declared up front via
:attr:`compile_levels`, so the captured variants stay a closed set.

The policy is deterministic and reads nothing from the device, so
consulting it adds no host sync, and it cannot change *what* tokens a
request emits — chunk boundaries only move admission and retirement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["AdaptiveChunkPolicy", "ChunkSignals", "DEFAULT_LEVELS",
           "percentiles"]

# Geometric ladder: round-down loses at most ~half the cap per step and
# reaching an exact boundary from any cap takes O(log) chunks.
DEFAULT_LEVELS: Tuple[int, ...] = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class ChunkSignals:
    """Host-side inputs to one chunk-length decision (all tick units).

    ``queue_depth`` counts *arrived* waiters.  ``min_active_slack`` is
    the minimum remaining token budget over active rows — the earliest
    tick a slot is guaranteed to free — or None with no active rows.
    ``slo_headroom`` is the minimum, over every tracked soft target and
    hard deadline, of ticks until it passes (clamped >= 1), or None
    when nothing is close.  ``next_arrival_in`` is the distance to the
    nearest *scheduled* future arrival (arrivals are engine ticks, so
    the host queue knows them) — a chunk spanning it would strand the
    newcomer until the far boundary even with a slot free.
    ``free_slots`` counts idle decode rows: with none free, a future
    arrival cannot admit before a slot frees anyway, so its boundary
    target shifts out to the slot-free event."""
    tick: int
    queue_depth: int
    free_slots: int = 0
    min_active_slack: Optional[int] = None
    slo_headroom: Optional[int] = None
    next_arrival_in: Optional[int] = None


class AdaptiveChunkPolicy:
    """Pick the next decode-chunk length from a frozen level ladder.

    Parameters
    ----------
    levels : ascending tuple of permitted chunk lengths — the DECLARED
        variant set (each level is one ``_decode_chunk`` variant).
    hot_queue : arrived-waiter count at which the queue counts as hot
        and the slack cap engages (default 1: any waiter).

    One policy instance belongs to one engine: it keeps the last
    decision only so the engine can count shrink/grow transitions.
    """

    def __init__(self, levels: Tuple[int, ...] = DEFAULT_LEVELS,
                 hot_queue: int = 1):
        lv = tuple(sorted(set(int(l) for l in levels)))
        if not lv or lv[0] < 1:
            raise ValueError(f"levels must be positive ints, got {levels!r}")
        if hot_queue < 1:
            raise ValueError("hot_queue must be >= 1")
        self.levels = lv
        self.hot_queue = hot_queue

    @property
    def compile_levels(self) -> Tuple[int, ...]:
        """Every chunk length this policy can ever ask for, PLUS the
        degraded-mode single-tick fallback — the full set of ``ticks``
        values a ``_decode_chunk`` variant may be captured for."""
        return tuple(sorted(set(self.levels) | {1}))

    def cap(self, sig: ChunkSignals) -> Optional[int]:
        """The boundary-distance cap implied by the signals, or None
        when nothing constrains the chunk (calm)."""
        cap: Optional[int] = None
        if (sig.queue_depth >= self.hot_queue
                and sig.min_active_slack is not None):
            cap = max(1, sig.min_active_slack)
        if sig.next_arrival_in is not None:
            # land a boundary where the newcomer can actually admit:
            # at its arrival with a slot free, else no earlier than the
            # next slot-free event (a boundary at arrival alone would
            # be a wasted sync — nothing could join there)
            a = sig.next_arrival_in
            if sig.free_slots <= 0 and sig.min_active_slack is not None:
                a = max(a, sig.min_active_slack)
            a = max(1, a)
            cap = a if cap is None else min(cap, a)
        if sig.slo_headroom is not None:
            h = max(1, sig.slo_headroom)
            cap = h if cap is None else min(cap, h)
        return cap

    def next_ticks(self, sig: ChunkSignals) -> int:
        """Largest level <= cap (never overshoot a slot-free event or an
        SLO edge), or the top level when calm."""
        cap = self.cap(sig)
        if cap is None:
            return self.levels[-1]
        pick = self.levels[0]
        for l in self.levels:
            if l <= cap:
                pick = l
        return pick

    def __repr__(self) -> str:  # shows up in engine diagnostics
        return (f"AdaptiveChunkPolicy(levels={self.levels}, "
                f"hot_queue={self.hot_queue})")


def percentiles(xs, qs=(50, 99)) -> Dict[str, float]:
    """p50/p99-style summary of a latency sample (empty-safe)."""
    if not len(xs):
        return {f"p{q}": 0.0 for q in qs}
    a = np.asarray(xs, np.float64)
    return {f"p{q}": float(np.percentile(a, q)) for q in qs}
