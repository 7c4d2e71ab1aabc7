"""Deterministic fault injection for the serving engine — numpy-only
copy of the reference's ``src/repro/serving/faults.py`` for the torch
port, with the same seeded choices, so one plan fires the same faults in
both engines.

Chaos testing for the continuous-batching stack: a :class:`FaultInjector`
carries a seeded plan of :class:`Fault` events and is consulted by the
engine at its natural hook points — step start, page allocation, chunk
start.  Every fault is injected through the engine's *public surface*
(device cache contents, the allocator call, the prefix-index entries, an
exception at the chunk boundary), never by monkey-patching internals, so
the recovery paths exercised are exactly the ones production traffic
would hit.  Fault kinds:

``nan_logit``
    Poison the K/V page holding the target request's last attended
    position with NaN before a decode chunk — its next logits go
    non-finite and the engine's guard must quarantine ONLY that row
    (status FAILED, pages freed and purged from the prefix index) while
    co-batched rows keep streaming bit-identically.  Prefers a
    refcount-1 (privately owned) page so the blast radius is exactly
    one request; fires only once the target is actually active.

``alloc_fail``
    The next ``count`` page allocations at admission raise
    :class:`InjectedFault` — modeling transient allocator failure.  The
    engine must unwind the half-admitted batch (no leaked refs), requeue
    it in order, and admit it cleanly on a later tick.

``index_corrupt``
    Scramble one prefix-index entry's page field (seeded choice) just
    before the engine's own ``verify()`` pass — the self-check must
    detect the inconsistency and drop the cache via the reference
    ledger (no leak, no double-free) instead of mapping a poisoned page
    into a new table.  Defers until the index actually has entries.

``chunk_exception``
    Raise :class:`InjectedFault` at the decode-chunk boundary — modeling
    a crash mid-``step()``.  The engine must restore its snapshot, stay
    usable, and fall back to degraded single-tick chunks.

Fire order within a plan is deterministic (sorted by tick, stable), the
corruption choice is seeded, and every fired fault is appended to
``injector.fired`` so tests and the ``serve.py --chaos`` smoke can
assert exactly what happened.

The port's page pools are torch tensors updated in place, and on the
card they are the storage a captured decode graph reads: a poisoned
page reaches a replayed chunk exactly as it reaches an eager one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Fault", "FaultInjector", "InjectedFault",
    "nan_logit", "alloc_failure", "index_corruption", "chunk_exception",
]


class InjectedFault(RuntimeError):
    """An injector-raised failure standing in for a real crash."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault.  ``tick`` is the earliest engine tick (chunk
    boundary) at which it may fire; some kinds defer further until their
    precondition holds (see module docstring)."""
    kind: str                  # nan_logit | alloc_fail | index_corrupt
    #                          # | chunk_exception
    tick: int
    rid: Optional[int] = None  # nan_logit: target request (None = any active)
    count: int = 1             # alloc_fail: allocations to fail

    def __post_init__(self):
        kinds = ("nan_logit", "alloc_fail", "index_corrupt",
                 "chunk_exception")
        if self.kind not in kinds:
            raise ValueError(f"unknown fault kind {self.kind!r}")


def nan_logit(tick: int, rid: Optional[int] = None) -> Fault:
    return Fault("nan_logit", tick, rid=rid)


def alloc_failure(tick: int, count: int = 1) -> Fault:
    return Fault("alloc_fail", tick, count=count)


def index_corruption(tick: int) -> Fault:
    return Fault("index_corrupt", tick)


def chunk_exception(tick: int) -> Fault:
    return Fault("chunk_exception", tick)


class FaultInjector:
    """Seeded, deterministic fault plan the engine consults at its hook
    points.  ``fired`` logs every injected event as ``(kind, tick,
    detail)`` tuples; ``pending`` lists what has not fired yet."""

    def __init__(self, faults: Sequence[Fault], seed: int = 0):
        self._pending: List[Fault] = sorted(faults, key=lambda f: f.tick)
        self._rng = np.random.default_rng(seed)
        self._alloc_budget = 0          # admissions still to fail
        self.fired: List[Tuple[str, int, Any]] = []

    @property
    def pending(self) -> List[Fault]:
        return list(self._pending)

    def exhausted(self) -> bool:
        return not self._pending and self._alloc_budget == 0

    def _due(self, engine, kind: str) -> List[Fault]:
        due = [f for f in self._pending
               if f.kind == kind and engine.tick >= f.tick]
        for f in due:
            self._pending.remove(f)
        return due

    # -- engine hooks ------------------------------------------------------

    def on_step_start(self, engine) -> None:
        """Chunk-boundary hook, called before the engine's own index
        verify pass — so an injected corruption must be caught by the
        self-check in the very same step."""
        for f in self._due(engine, "index_corrupt"):
            if not self._corrupt_index(engine):
                self._pending.append(f)      # no entries yet: defer

    def on_alloc(self, engine, need: int) -> None:
        """Called immediately before ``pool.alloc_pages`` at admission."""
        for f in self._due(engine, "alloc_fail"):
            self._alloc_budget += f.count
        if self._alloc_budget > 0:
            self._alloc_budget -= 1
            self.fired.append(("alloc_fail", engine.tick, need))
            raise InjectedFault(
                f"injected allocator failure at tick {engine.tick} "
                f"({need} pages requested)")

    def on_chunk_start(self, engine, active: Sequence[int],
                       ticks: Optional[int] = None) -> None:
        """Called after the COW guard, right before the decode chunk.
        ``ticks`` is the length the engine committed to for THIS chunk —
        under an adaptive policy that varies per
        boundary, and logging it lets chaos × SLO tests assert a fault
        fired inside a specific chunk length (e.g. a shrunk one).  A
        chunk_exception here aborts the whole chunk before any tick of
        it runs: the engine restores its snapshot and degrades to
        single-tick chunks, which overrides the adaptive policy until
        the engine is rebuilt (degraded wins — every retry must be the
        smallest replayable unit)."""
        for f in self._due(engine, "nan_logit"):
            if not self._poison(engine, active, f.rid):
                self._pending.append(f)      # target not active yet: defer
        for f in self._due(engine, "chunk_exception"):
            self.fired.append(("chunk_exception", engine.tick,
                               {"ticks": ticks}))
            raise InjectedFault(
                f"injected decode-chunk crash at tick {engine.tick}")

    # -- fault implementations ---------------------------------------------

    def _poison(self, engine, active: Sequence[int],
                rid: Optional[int]) -> bool:
        """NaN-fill one K/V page of the target row in every attention
        layer.  The page must hold at least one attended position
        (< cache_len) for the poison to reach the logits; pages are
        scanned back from the one holding ``cache_len - 1``, preferring
        refcount 1 so only the target row reads it."""
        slot = None
        for i in active:
            s = engine.slots[i]
            if s is not None and (rid is None or s.req.rid == rid):
                slot = i
                break
        if slot is None:
            if rid is not None and rid in engine.requests \
                    and engine.requests[rid].terminal:
                self.fired.append(("nan_logit", engine.tick,
                                   f"rid {rid} already terminal: skipped"))
                return True                  # never going to be active
            return False
        ps = engine.pool.page_size
        last = (int(engine._cache_len[slot]) - 1) // ps
        candidates = [int(engine._tables[slot, j]) for j in range(last, -1, -1)]
        pid = next((p for p in candidates if engine.pool.refcount(p) == 1),
                   candidates[0])
        for c in engine.caches:
            if isinstance(c, dict) and "k" in c:
                c["k"][pid] = float("nan")          # in place: the pool
                c["v"][pid] = float("nan")          # a graph replays over
        self.fired.append(
            ("nan_logit", engine.tick,
             {"rid": engine.slots[slot].req.rid, "slot": slot, "page": pid}))
        return True

    def _corrupt_index(self, engine) -> bool:
        """Scramble one entry's page field to a different id (seeded
        pick among the index's other pages, else the null page)."""
        idx = engine.prefix_index
        if idx is None or not len(idx):
            return False
        entries = list(idx._entries.values())
        victim = entries[int(self._rng.integers(len(entries)))]
        others = sorted(p for p in idx._owned if p != victim.page)
        bogus = (int(others[int(self._rng.integers(len(others)))])
                 if others else 0)
        self.fired.append(("index_corrupt", engine.tick,
                           {"page": victim.page, "scrambled_to": bogus}))
        victim.page = bogus
        return True
