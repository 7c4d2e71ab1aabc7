"""Continuous-batching scheduler: priority admission gated on slots + pages.

Requests queue in (priority, arrival) order — all-default priorities
reduce to plain arrival FIFO; at every engine tick the scheduler
admits the arrived waiter with the best aging-adjusted priority while
(i) a decode slot is free and
(ii) the page pool can cover the request's *whole* budget —
``prompt_len + max_new`` tokens — up front.  Reserving the full budget
at admission is the eviction-freedom invariant: an admitted sequence can
always run to its last token without preemption, so mid-stream joins are
token-identical to solo decodes (DESIGN.md §9).  Head-of-line blocking
is deliberate — skipping ahead to smaller requests would starve long
prompts under sustained load.

With a :class:`~repro_torch.serving.pages.PrefixIndex` attached, the
accounting runs *under sharing* (DESIGN.md §12): a request's page need
is discounted by its cached-prefix hits (those pages are mapped, not
allocated), and cache-only index pages (refcount 1, pinned by no
same-tick sibling's hits) count as available — the engine evicts them
leaf-first on demand.  The invariant is unchanged: once admitted, every
page a request will ever write is privately owned, so it still runs to
its last token without preemption.

DESIGN.md §13 adds the request *lifecycle*: every request carries a
:class:`RequestStatus` and ends in exactly one terminal state —

    QUEUED ──admit──> ACTIVE ──────────────> FINISHED (EOS / budget)
      │  │                │ │ │
      │  │                │ │ └─ guard trip ─> FAILED   (quarantined)
      │  │                │ └─── deadline ───> EXPIRED  (partial tokens)
      │  │                └──── cancel() ────> CANCELLED(partial tokens)
      │  ├──── cancel() ─────────────────────> CANCELLED(no tokens)
      │  └──── deadline ─────────────────────> EXPIRED  (no tokens)
      └ submit() over max_queue ─────────────> REJECTED (backpressure)

The waiting queue is *bounded* (``max_queue``): an over-capacity
:meth:`submit` marks the request REJECTED instead of growing the queue
without limit — explicit admission-reject backpressure rather than
unbounded latency.  Queue insertion is an ordered ``bisect.insort`` on
the ``(priority, arrival)`` key (stable within equal keys).

DESIGN.md §15 adds **priority classes with aging**.  Requests carry a
``priority`` (lower = more urgent, default 0) and optional *soft* SLO
targets (``ttft_target_ticks`` / ``tpot_target_ticks`` — measured and
capped against, never enforced by killing, unlike the hard
``deadline_ticks``).  Admission picks the arrived waiter with the
smallest :meth:`effective_priority` — the static class minus one level
per ``aging_ticks`` of queue wait — with queue position (priority,
arrival, submit order) as the tie-break.  Aging is the anti-starvation
rule: a low-priority request's effective priority drops below any fresh
class after a bounded wait, so sustained high-priority load can delay
it only ``(priority - minimum priority + 1) * aging_ticks`` ticks
before it *is* the effective head.  Head-of-line blocking then applies
to that effective head exactly as it did to the FIFO head: nobody
skips past it just for being smaller, so big requests cannot starve
either.  With every priority equal (the default) the order degenerates
to the plain arrival FIFO bit-for-bit.
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import List, Optional, Sequence

import numpy as np

from repro_torch import tracing

from .pages import PagePool, PrefixIndex

__all__ = ["Request", "RequestStatus", "Scheduler", "TERMINAL_STATUSES"]


class RequestStatus(str, enum.Enum):
    """Lifecycle states of a request (DESIGN.md §13).  The five
    right-hand states are terminal; every submitted request reaches
    exactly one of them."""
    QUEUED = "queued"          # waiting for a slot + pages
    ACTIVE = "active"          # holds a decode slot
    FINISHED = "finished"      # EOS or budget exhausted — the happy path
    CANCELLED = "cancelled"    # cancel(rid) honored (chunk boundary if active)
    EXPIRED = "expired"        # deadline passed (waiting or mid-stream)
    FAILED = "failed"          # quarantined by the non-finite guard
    REJECTED = "rejected"      # bounded-queue admission reject (backpressure)


TERMINAL_STATUSES = frozenset({
    RequestStatus.FINISHED, RequestStatus.CANCELLED, RequestStatus.EXPIRED,
    RequestStatus.FAILED, RequestStatus.REJECTED,
})


@dataclasses.dataclass
class Request:
    """One generation request in the stream.

    ``temperature`` / ``top_k`` / ``top_p`` override the engine-level
    sampling defaults for this request alone — co-batched requests keep
    independent sampling because the decode chunk threads them through
    the scan as per-slot ``(B,)`` vectors (DESIGN.md §10).  ``None``
    means "inherit the engine default".

    ``deadline_ticks`` is a per-request latency budget relative to
    ``arrival``: once ``engine.tick`` reaches ``arrival +
    deadline_ticks`` the request is EXPIRED — dropped from the queue if
    still waiting, aborted at the next chunk boundary (keeping the
    tokens emitted so far) if active.

    ``priority`` (lower = more urgent) orders admission;
    ``ttft_target_ticks`` / ``tpot_target_ticks`` are *soft* SLO
    targets (DESIGN.md §15): the adaptive chunk policy shrinks chunks
    to land boundaries inside them and :meth:`ServingEngine.slo_stats`
    counts the misses, but — unlike ``deadline_ticks`` — blowing one
    never terminates the request."""
    rid: int
    prompt: np.ndarray            # (L,) int32 prompt tokens
    max_new: int                  # generation budget (incl. first token)
    arrival: int = 0              # earliest engine tick it may be admitted
    temperature: Optional[float] = None   # <= 0: greedy argmax
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    deadline_ticks: Optional[int] = None  # must FINISH by arrival + this
    priority: int = 0             # admission class; lower = more urgent
    ttft_target_ticks: Optional[int] = None  # soft: admit within this
    tpot_target_ticks: Optional[int] = None  # soft: stream cadence bound
    # filled by the engine:
    status: RequestStatus = RequestStatus.QUEUED
    status_reason: Optional[str] = None   # human-readable terminal cause
    tokens: Optional[np.ndarray] = None   # emitted tokens, set on finish
    admitted_at: Optional[int] = None
    finished_at: Optional[int] = None
    prefix_hit_pages: int = 0             # prefix-cache pages mapped at admit
    first_token_time: Optional[float] = None  # wall clock of first token
    finished_time: Optional[float] = None     # wall clock of terminal event
    queued_ns: Optional[int] = None   # time.time_ns() at submit, while tracing

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def budget_tokens(self) -> int:
        """Cache slots the request needs end-to-end: the prompt plus every
        generated token except the last (whose KV is written but never
        attended — kept for simplicity)."""
        return self.prompt_len + self.max_new

    @property
    def deadline(self) -> Optional[int]:
        """Absolute engine tick this request must finish by, or None."""
        if self.deadline_ticks is None:
            return None
        return self.arrival + self.deadline_ticks

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def ttft_ticks(self) -> Optional[int]:
        """Ticks from arrival to first token (prefill argmax lands at
        the admission tick), or None if never admitted."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.arrival

    @property
    def tpot_ticks(self) -> Optional[float]:
        """Mean ticks per generated token after the first, or None
        before the request is terminal with tokens."""
        if (self.admitted_at is None or self.finished_at is None
                or self.tokens is None or len(self.tokens) == 0):
            return None
        return ((self.finished_at - self.admitted_at)
                / max(len(self.tokens) - 1, 1))

    @property
    def ttft_missed(self) -> bool:
        """Soft TTFT target blown: admitted later than ``arrival +
        ttft_target_ticks`` — or terminal without ever being admitted
        while a target was set."""
        if self.ttft_target_ticks is None:
            return False
        if self.admitted_at is None:
            return self.terminal
        return self.ttft_ticks > self.ttft_target_ticks

    @property
    def tpot_missed(self) -> bool:
        """Soft per-token target blown on average over the stream."""
        tpot = self.tpot_ticks
        return (self.tpot_target_ticks is not None and tpot is not None
                and tpot > self.tpot_target_ticks)


def _queue_key(r: Request):
    """Static queue order: priority class first, arrival inside it.
    Aging shifts *admission choice* (effective_priority), not storage
    order — the list stays sorted under one immutable key."""
    return (r.priority, r.arrival)


class Scheduler:
    """Priority queue + admission policy over a :class:`PagePool`,
    optionally prefix-cache-aware via a :class:`PrefixIndex` and bounded
    at ``max_queue`` waiting requests (None = unbounded).

    ``aging_ticks`` is the anti-starvation knob (DESIGN.md §15): every
    ``aging_ticks`` of queue wait promotes a request one effective
    priority level at admission time.  None disables aging (static
    classes only — a sustained stream of higher-priority arrivals can
    then starve lower classes; tests pin down that the default cannot).
    With every request at the default priority 0 the whole policy
    reduces to the plain arrival FIFO exactly."""

    def __init__(self, pool: PagePool, index: Optional[PrefixIndex] = None,
                 max_queue: Optional[int] = None,
                 aging_ticks: Optional[int] = 32):
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if aging_ticks is not None and aging_ticks < 1:
            raise ValueError("aging_ticks must be >= 1 (or None to disable)")
        self.pool = pool
        self.index = index
        self.max_queue = max_queue
        self.aging_ticks = aging_ticks
        self.waiting: List[Request] = []
        self.finished: List[Request] = []      # every TERMINAL request

    def submit(self, req: Request) -> bool:
        """Queue a request, or REJECT it if the bounded queue is full.
        Returns True iff the request was queued.

        The queue is kept in (priority, arrival, submit-order) order —
        the static key admission tie-breaks on.  ``insort``'s
        insert-after-equals keeps equal-key requests in submit order."""
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            self.finish_waiting(
                req, tick=None, status=RequestStatus.REJECTED,
                reason=f"queue full ({self.max_queue} waiting)")
            return False
        bisect.insort(self.waiting, req, key=_queue_key)
        return True

    def requeue(self, reqs: Sequence[Request]) -> None:
        """Put not-yet-started admissions back (e.g. after an allocator
        failure mid-admission): insort_left places each request *before*
        equal-key waiters, restoring its original queue position;
        inserting in reverse keeps the batch's own relative order."""
        for req in reversed(list(reqs)):
            bisect.insort_left(self.waiting, req, key=_queue_key)

    def remove(self, rid: int) -> Optional[Request]:
        """Pull a waiting request out of the queue (cancel path).
        Returns it, or None if ``rid`` is not waiting."""
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                return self.waiting.pop(i)
        return None

    def expire(self, tick: int) -> List[Request]:
        """Sweep the queue for requests whose deadline has passed:
        each is removed and marked EXPIRED (terminal, no tokens)."""
        out = []
        keep = []
        for r in self.waiting:
            if r.deadline is not None and tick >= r.deadline:
                self.finish_waiting(
                    r, tick, RequestStatus.EXPIRED,
                    reason=f"deadline {r.deadline} passed while queued")
                out.append(r)
            else:
                keep.append(r)
        if out:
            self.waiting = keep
        return out

    def finish_waiting(self, req: Request, tick: Optional[int],
                        status: RequestStatus, reason: str) -> None:
        """Terminal transition for a request that never held a slot."""
        req.status = status
        req.status_reason = reason
        req.tokens = np.zeros((0,), np.int32)
        req.finished_at = tick
        self.finished.append(req)

    def pages_needed(self, req: Request) -> int:
        """Private pages the request would need right now: its full
        budget minus the page-aligned prefix blocks already cached."""
        need = self.pool.pages_for(req.budget_tokens)
        if self.index is not None:
            need -= len(self.index.match(req.prompt))
        return need

    def effective_priority(self, req: Request, tick: int) -> int:
        """The request's priority as admission sees it *now*: the static
        class minus one level per ``aging_ticks`` of queue wait.  Lower
        wins.  Monotonically non-increasing in wait time, so any waiter
        eventually undercuts every fresh arrival of every class — the
        starvation-freedom argument the property tests replay."""
        if self.aging_ticks is None:
            return req.priority
        return req.priority - max(0, tick - req.arrival) // self.aging_ticks

    def _effective_head_index(self, tick: int) -> Optional[int]:
        tracing.count("scheduler.waiting_scanned", len(self.waiting))
        best = None
        for i, r in enumerate(self.waiting):
            if r.arrival > tick:
                continue
            key = (self.effective_priority(r, tick), i)
            if best is None or key < best[0]:
                best = (key, i)
        return best[1] if best is not None else None

    def effective_head(self, tick: int) -> Optional[Request]:
        """The arrived waiter admission would consider next: minimum
        (effective_priority, queue position), or None if nothing has
        arrived.  Queue position — the static (priority, arrival,
        submit-order) — is the tie-break, so all-default-priority
        traffic selects exactly the old FIFO head."""
        i = self._effective_head_index(tick)
        return self.waiting[i] if i is not None else None

    def admit(self, tick: int, free_slots: int) -> List[Request]:
        """Pop admissible requests for this tick in effective-priority
        order: arrived, a slot free, and the pool able to reserve the
        full token budget.

        Under prefix caching the budget is discounted by cached-prefix
        hits, and index pages evictable *right now* — refcount 1 and not
        among the hits already promised (``pinned``) to earlier
        admissions of this same tick — count as free.  Hits only ever
        grow between this gate and the engine's allocation (same-tick
        siblings insert fresh blocks; eviction never touches pinned
        pages), so the reservation is a safe upper bound.

        Head-of-line blocking applies to the *effective* head: when the
        most-urgent arrived waiter does not fit, nothing behind it is
        admitted either — skipping ahead to smaller requests would
        starve long prompts, the exact hazard aging exists to rule
        out."""
        with tracing.span("scheduler.admit"):
            return self._admit(tick, free_slots)

    def _admit(self, tick: int, free_slots: int) -> List[Request]:
        out: List[Request] = []
        reserved = 0   # pages already committed to this tick's admissions
        pinned: set = set()
        while self.waiting and free_slots > 0:
            hi = self._effective_head_index(tick)
            if hi is None:
                break
            head = self.waiting[hi]
            hits: List[int] = []
            if self.index is not None:
                hits = self.index.match(head.prompt)
            need = self.pool.pages_for(head.budget_tokens) - len(hits)
            avail = self.pool.free_pages
            if self.index is not None:
                avail += self.index.evictable_pages(
                    exclude=pinned | set(hits))
            if reserved + need > avail:
                break  # effective head-of-line blocks until pages free up
            reserved += need
            pinned.update(hits)
            out.append(self.waiting.pop(hi))
            free_slots -= 1
        return out

    def retire(self, req: Request, pages: Sequence[int], tick: int,
               status: RequestStatus = RequestStatus.FINISHED,
               reason: Optional[str] = None) -> None:
        """Release the request's references and record its terminal
        status.  Under sharing the free is a refcount decrement: a page
        returns to the free list only when no other table (and no
        prefix-index entry) still maps it."""
        req.status = status
        req.status_reason = reason
        req.finished_at = tick
        self.pool.free(pages)
        self.finished.append(req)

    @property
    def pending(self) -> int:
        return len(self.waiting)
