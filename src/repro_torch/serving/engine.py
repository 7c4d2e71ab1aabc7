"""Continuous-batching serving engine over paged KV caches — torch port of
``src/repro/serving/engine.py`` (greedy decoding).

The engine owns ``num_slots`` decode rows and one fp32 page pool per
attention layer.  Each ``step`` is one scheduler event:

1. **admission** — the scheduler hands over requests whose token budget
   fits in the pool; each gets a slot, fresh pages and a paged prefill of
   its prompt whose K/V lands straight in its pages.  With prefix caching
   the prompt's longest page-aligned cached prefix is mapped instead of
   recomputed and only the tail is prefilled at its ``start_pos`` (the
   match is capped one token short, so the tail is never empty).
2. **decode** — ``ticks_per_sync`` decode steps for all slots, with
   per-row ``done``/budget freezing and the non-finite guard, then ONE
   device-to-host transfer of the whole token block.
3. **retirement** — finished rows give their pages back.

Every row attends only over its own ``[0, cache_len)`` and its pages are
exclusively owned, so a stream is token-identical to the same request
decoded alone.  Not ported yet (see ROADMAP.md): sampling, the fault
injector, cancellation/deadline servicing, snapshot/restore crash
recovery and the adaptive SLO chunk policy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import _check_ported, lm_decode, lm_prefill

from .pages import NULL_PAGE, PagePool, PrefixIndex
from .scheduler import Request, RequestStatus, Scheduler

__all__ = ["ServingEngine"]


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: List[int]
    emitted: List[int]


@torch.no_grad()
def _paged_prefill_step(params, tokens, caches, table, *, cfg, start=0,
                        guard=True):
    """Paged prefill-on-join of a (1, L) prompt (tail) straight into the
    pool pages named by ``table`` (1, max_pages).  ``start > 0`` is the
    prefix-cache tail at logical positions ``[start, start+L)``.  Returns
    (first token (1,), all-finite flag) as device tensors."""
    logits, _ = lm_prefill(params, caches,
                           {"tokens": tokens, "page_tables": table}, cfg,
                           start_pos=start)
    last = logits[:, -1]
    first = torch.argmax(last, dim=-1).to(torch.int32)
    ok = (torch.isfinite(last).all() if guard
          else torch.ones((), dtype=torch.bool, device=last.device))
    return first, ok


@torch.no_grad()
def _decode_chunk(params, caches, tok, cache_len, tables, budget_left, *,
                  cfg, ticks, eos_id, guard):
    """``ticks`` batched greedy decode steps, all on the device.

    A row freezes the moment it emits ``eos_id`` or exhausts
    ``budget_left``: it keeps its token and ``cache_len`` for the rest of
    the chunk and its lockstep output is discarded (its page writes land
    at its frozen ``cache_len``, attended by nobody).  With ``guard`` a
    row whose logits go non-finite freezes at that tick and is flagged
    ``bad``.  The reference skips the decode body once every row is done;
    here the loop runs all ``ticks`` so that no per-tick host check is
    needed — the extra steps change no emitted token.

    Returns (tokens (ticks, B), emitted counts (B,), bad (B,), last tok
    (B, 1), cache_len (B,)), all on the device."""
    b = tok.shape[0]
    done = budget_left <= 0            # free slots ride along frozen
    bad = torch.zeros((b,), dtype=torch.bool, device=tok.device)
    left = budget_left.clone()
    emits, lives = [], []
    for _ in range(ticks):
        logits, caches = lm_decode(
            params, caches, {"tokens": tok, "page_tables": tables}, cache_len,
            cfg)
        last = logits[:, -1]
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        live = ~done
        if guard:
            finite = torch.isfinite(last).all(dim=-1)
            bad = bad | (live & ~finite)
            live = live & finite
            done = done | bad
        emit = torch.where(live, nxt, tok[:, 0])
        left = torch.where(live, left - 1, left)
        done = done | (left <= 0)
        if eos_id is not None:
            done = done | (live & (emit == eos_id))
        cache_len = torch.where(live, cache_len + 1, cache_len)
        tok = torch.where(live[:, None], nxt[:, None], tok)
        emits.append(emit)
        lives.append(live)
    toks = torch.stack(emits)
    counts = torch.stack(lives).to(torch.int32).sum(dim=0)
    return toks, counts, bad, tok, cache_len


class ServingEngine:
    """Request-level greedy serving: paged KV pool + continuous batching.

    Parameters
    ----------
    params : dense or BSR-packed params tree (both serve through
        ``models/layers.matmul``).
    cfg : model config (attention + dense-MLP stacks; no SWA windows).
    num_slots : decode-batch rows.
    page_size : tokens per physical KV page.
    max_seq_len : longest prompt + generation a request may hold.
    num_pages : physical pages per layer pool (page 0 is the null page);
        defaults to every slot holding a full-length sequence.
    ticks_per_sync : decode steps between two scheduler events.
    prefix_caching : share page-aligned prompt-prefix K/V across requests.
    nan_guard : freeze and fail rows whose logits go non-finite.
    device : the card by default; ``"cpu"`` runs the plain versions.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        num_slots: int = 4,
        page_size: int = 8,
        max_seq_len: int = 64,
        num_pages: Optional[int] = None,
        ticks_per_sync: int = 1,
        aging_ticks: Optional[int] = 32,
        eos_id: Optional[int] = None,
        prefix_caching: bool = True,
        max_queue: Optional[int] = None,
        nan_guard: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        if cfg.window is not None:
            raise ValueError("paged KV caches do not support SWA windows")
        _check_ported(cfg)
        if ticks_per_sync < 1:
            raise ValueError("ticks_per_sync must be >= 1")
        self.params, self.cfg = params, cfg
        self.num_slots = num_slots
        self.ticks_per_sync = ticks_per_sync
        self.max_pages = -(-max_seq_len // page_size)
        if num_pages is None:
            num_pages = num_slots * self.max_pages + 1
        self.pool = PagePool(num_pages, page_size)
        self.prefix_caching = bool(prefix_caching)
        self.prefix_index = PrefixIndex(self.pool) if self.prefix_caching else None
        self.scheduler = Scheduler(self.pool, self.prefix_index,
                                   max_queue=max_queue, aging_ticks=aging_ticks)
        self.eos_id = eos_id
        self.nan_guard = bool(nan_guard)
        self.prefix_lookups = 0
        self.prefix_hit_requests = 0
        self.prefix_pages_shared = 0
        self.rejected = 0
        self.failed = 0
        self.guard_trips = 0

        shape = (num_pages, page_size, cfg.kv_heads, cfg.head_dim_())
        self.caches = [
            {"k": torch.zeros(shape, dtype=torch.float32, device=self.device),
             "v": torch.zeros(shape, dtype=torch.float32, device=self.device)}
            for _ in range(cfg.n_layers)]

        # host-mirrored per-slot state, pushed to the device every chunk
        self._tok = np.zeros((num_slots, 1), np.int32)
        self._cache_len = np.zeros((num_slots,), np.int32)
        self._tables = np.full((num_slots, self.max_pages), NULL_PAGE, np.int32)
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        self.requests: Dict[int, Request] = {}
        self.tick = 0
        self._next_rid = 0
        self.active_slot_ticks = 0
        self.decode_ticks = 0
        # wall clock at which each request was first due (arrival reached)
        self.due_time: Dict[int, float] = {}

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, max_new: int, arrival: int = 0, *,
               priority: int = 0) -> int:
        """Queue a greedy request and return its rid.  Past a bounded
        queue the request is REJECTED (terminal at once)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new < 1 or prompt.size < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        oob = np.nonzero((prompt < 0) | (prompt >= self.cfg.vocab))[0]
        if oob.size:
            pos = int(oob[0])
            raise ValueError(
                f"prompt token id {int(prompt[pos])} at position {pos} is "
                f"outside [0, {self.cfg.vocab})")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      arrival=arrival, priority=priority)
        if self.pool.pages_for(req.budget_tokens) > self.max_pages:
            raise ValueError(
                f"request needs {req.budget_tokens} tokens > "
                f"max_seq_len {self.max_pages * self.pool.page_size}")
        self._next_rid += 1
        self.requests[req.rid] = req
        if not self.scheduler.submit(req):
            self.rejected += 1
        return req.rid

    # -- engine loop -------------------------------------------------------

    def _admit(self) -> int:
        free = [i for i, s in enumerate(self.slots) if s is None]
        admitted = self.scheduler.admit(self.tick, len(free))
        # pages promised to this batch's admissions: eviction below must
        # never reclaim a page a sibling's reservation counted on
        pins = set()
        if self.prefix_index is not None:
            for req in admitted:
                pins.update(self.prefix_index.match(req.prompt))
        count = 0
        for req in admitted:
            slot = free.pop(0)
            hits: List[int] = []
            if self.prefix_index is not None:
                self.prefix_lookups += 1
                hits = self.prefix_index.match(req.prompt)
            n_hit = len(hits)
            total = self.pool.pages_for(req.budget_tokens)
            need = total - n_hit
            if self.prefix_index is not None and need > self.pool.free_pages:
                self.prefix_index.evict(need - self.pool.free_pages,
                                        exclude=pins | set(hits))
            fresh = self.pool.alloc_pages(need)
            self.pool.share(hits)                 # map, don't recompute
            pages = hits + fresh
            self._tables[slot] = NULL_PAGE
            self._tables[slot, :total] = pages
            start = n_hit * self.pool.page_size
            dev = self.device
            first, ok = _paged_prefill_step(
                self.params,
                torch.as_tensor(req.prompt[start:][None], device=dev),
                self.caches,
                torch.as_tensor(self._tables[slot][None], device=dev),
                cfg=self.cfg, start=start, guard=self.nan_guard)
            # one host round-trip per admission: first token + guard flag
            first_ok = torch.stack([first[0], ok.to(torch.int32)]).cpu().numpy()
            if self.nan_guard and not bool(first_ok[1]):
                self.guard_trips += 1
                self.failed += 1
                req.tokens = np.zeros((0,), np.int32)
                if self.prefix_index is not None:
                    self.prefix_index.drop_pages(pages)
                self._tables[slot] = NULL_PAGE
                self.scheduler.retire(
                    req, pages, self.tick, status=RequestStatus.FAILED,
                    reason="non-finite prefill logits (quarantined)")
                free.insert(0, slot)
                continue
            self._cache_len[slot] = req.prompt_len
            tok = int(first_ok[0])
            req.first_token_time = time.perf_counter()
            req.prefix_hit_pages = n_hit
            if self.prefix_index is not None:
                self.prefix_index.insert(req.prompt, pages)
                if n_hit:
                    self.prefix_hit_requests += 1
                self.prefix_pages_shared += n_hit
            self._tok[slot, 0] = tok
            req.admitted_at = self.tick
            req.status = RequestStatus.ACTIVE
            self.slots[slot] = _Slot(req=req, pages=pages, emitted=[tok])
            count += 1
            self._maybe_finish(slot)
        return count

    def _cow_guard(self, active: List[int], ticks: int) -> None:
        """Copy-on-write before a decode chunk: no row may write into a
        page it does not exclusively own.  Admission makes this
        unreachable (decode writes land in private tail pages); any
        trigger copies the target page and repoints the row's table."""
        ps = self.pool.page_size
        for i in active:
            s = self.slots[i]
            lo = int(self._cache_len[i])
            hi = lo + ticks
            for idx in range(lo // ps, (hi - 1) // ps + 1):
                if idx >= self.max_pages:
                    break
                pid = int(self._tables[i, idx])
                if pid == NULL_PAGE or self.pool.refcount(pid) == 1:
                    continue
                if self.pool.free_pages == 0 and self.prefix_index is not None:
                    self.prefix_index.evict(1, exclude=set(s.pages))
                new = self.pool.cow(pid)
                for c in self.caches:
                    c["k"][new] = c["k"][pid]
                    c["v"][new] = c["v"][pid]
                self._tables[i, idx] = new
                s.pages[s.pages.index(pid)] = new

    def _release_slot(self, i: int, status: RequestStatus,
                      reason: Optional[str] = None) -> None:
        s = self.slots[i]
        s.req.tokens = np.asarray(s.emitted, np.int32)
        s.req.finished_time = time.perf_counter()
        if status is RequestStatus.FAILED and self.prefix_index is not None:
            self.prefix_index.drop_pages(s.pages)
        self.slots[i] = None
        self._tables[i] = NULL_PAGE
        self._cache_len[i] = 0
        self._tok[i, 0] = 0
        self.scheduler.retire(s.req, s.pages, self.tick, status=status,
                              reason=reason)

    def _maybe_finish(self, slot: int) -> None:
        s = self.slots[slot]
        if s is None:
            return
        if (len(s.emitted) >= s.req.max_new
                or (self.eos_id is not None and s.emitted[-1] == self.eos_id)):
            self._release_slot(slot, RequestStatus.FINISHED)

    def step(self) -> int:
        """One scheduler event: admission, then one chunk of
        ``ticks_per_sync`` decode steps.  Returns the admissions."""
        now = time.perf_counter()
        for r in self.scheduler.waiting:
            if r.arrival <= self.tick:
                self.due_time.setdefault(r.rid, now)
        admitted = self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self.tick += 1
            return admitted
        ticks = self.ticks_per_sync
        self._cow_guard(active, ticks)
        left = np.zeros((self.num_slots,), np.int32)
        for i in active:
            left[i] = self.slots[i].req.max_new - len(self.slots[i].emitted)
        dev = self.device
        toks, counts, bad, tok, clen = _decode_chunk(
            self.params, self.caches,
            torch.as_tensor(self._tok, device=dev),
            torch.as_tensor(self._cache_len, device=dev),
            torch.as_tensor(self._tables, device=dev),
            torch.as_tensor(left, device=dev),
            cfg=self.cfg, ticks=ticks, eos_id=self.eos_id,
            guard=self.nan_guard)
        # ONE host round-trip per decode chunk
        packed = torch.cat([toks, counts[None], bad.to(torch.int32)[None],
                            tok.T, clen.to(torch.int32)[None]]).cpu().numpy()
        toks, counts, bad = packed[:ticks], packed[ticks], packed[ticks + 1]
        self._tok = packed[ticks + 2][:, None].astype(np.int32)
        self._cache_len = packed[ticks + 3].astype(np.int32)
        for i in active:
            self.slots[i].emitted.extend(int(t) for t in toks[:int(counts[i]), i])
            if bad[i]:
                self.guard_trips += 1
                self.failed += 1
                self._release_slot(i, RequestStatus.FAILED,
                                   reason="non-finite decode logits (quarantined)")
            else:
                self._maybe_finish(i)
        self.active_slot_ticks += int(counts.sum())
        self.decode_ticks += ticks
        self.tick += ticks
        return admitted

    @property
    def prefix_stats(self) -> Dict[str, int]:
        """Prefix-cache counters: lookups, hit requests, pages mapped
        instead of prefilled, blocks indexed, evictions, COW copies and
        the refcount high-water mark."""
        idx = self.prefix_index
        return {
            "enabled": int(self.prefix_caching),
            "lookups": self.prefix_lookups,
            "hit_requests": self.prefix_hit_requests,
            "pages_shared": self.prefix_pages_shared,
            "blocks_indexed": len(idx) if idx is not None else 0,
            "evictions": idx.evictions if idx is not None else 0,
            "cow_copies": self.pool.cow_copies,
            "ref_high_water": self.pool.ref_high_water,
        }

    def release_prefix_cache(self) -> int:
        """Drop every cached prefix block; pages still mapped by active
        requests survive on their own references.  Returns entries
        released."""
        if self.prefix_index is None:
            return 0
        return self.prefix_index.clear()

    def _state(self) -> str:
        waiting = [(r.rid, r.budget_tokens, self.scheduler.pages_needed(r),
                    r.arrival) for r in self.scheduler.waiting]
        active = [(s.req.rid, len(s.emitted), s.req.max_new)
                  for s in self.slots if s is not None]
        return (f"tick={self.tick} waiting(rid,budget_tok,pages,arrival)="
                f"{waiting} active(rid,emitted,max_new)={active} "
                f"pool={self.pool.free_pages}/{self.pool.num_pages - 1} free")

    def run(self, max_ticks: int = 100_000) -> Dict[int, Request]:
        """Drive chunks until every submitted request is terminal; returns
        the terminal requests by rid."""
        while self.scheduler.pending or any(s is not None for s in self.slots):
            if self.tick >= max_ticks:
                raise RuntimeError(
                    f"engine stalled after {max_ticks} ticks: {self._state()}")
            idle = all(s is None for s in self.slots)
            due = any(r.arrival <= self.tick for r in self.scheduler.waiting)
            failed_before = self.failed
            admitted = self.step()
            if idle and due and not admitted and self.failed == failed_before:
                raise RuntimeError(f"admission stalled: {self._state()}")
        return {r.rid: r for r in self.scheduler.finished}

    def ttft_seconds(self, rid: int) -> Optional[float]:
        """Wall seconds from the step in which the request was first due
        to its first token (None if it never produced one)."""
        req = self.requests[rid]
        if req.first_token_time is None or rid not in self.due_time:
            return None
        return req.first_token_time - self.due_time[rid]

    @property
    def slot_utilization(self) -> float:
        if not self.decode_ticks:
            return 0.0
        return self.active_slot_ticks / (self.decode_ticks * self.num_slots)
