"""Continuous-batching serving engine over paged KV caches — torch port of
``src/repro/serving/engine.py``.

The engine owns ``num_slots`` decode rows, one fp32 page pool per
attention layer and, per recurrent layer (Mamba, mLSTM, sLSTM), an
ordinary ``(num_slots, ...)`` row of state per slot, as the reference
keeps them.  Each ``step`` is one scheduler event:

1. **servicing** — the fault injector's step hook, the prefix-index
   self-check, pending cancels and deadlines;
2. **admission** — the scheduler hands over requests whose token budget
   fits in the pool; each gets a slot, fresh pages and a paged prefill of
   its prompt whose K/V lands straight in its pages; a recurrent layer
   starts the slot's row from the initial state and leaves the prompt's
   final state there.  With prefix caching (attention-only stacks: a
   recurrent state cannot be resumed from pages, so it is off otherwise)
   the prompt's longest page-aligned cached prefix is mapped instead of
   recomputed and only the tail is prefilled at its ``start_pos`` (the
   match is capped one token short, so the tail is never empty).  On the
   card the prefill is a CUDA graph captured once per ``(L, start,
   guard)`` and replayed for every slot; on the CPU it runs eagerly.  A
   failed page allocation requeues the rest of the batch unchanged;
3. **decode** — one chunk of ``ticks`` decode steps for all slots (the
   fixed ``ticks_per_sync``, or the adaptive policy's pick), with
   per-row ``done``/budget freezing, per-row sampling params and PRNG
   keys, and the non-finite guard (a frozen or free row's recurrent
   state advances with the batch, as in the reference: nobody reads it
   before the slot's next admission resets it), then ONE device-to-host
   transfer of the packed outputs.  On the card the chunk is a CUDA
   graph captured once per ``(ticks, sampled)`` variant and replayed
   (:mod:`repro_torch.serving.graphs`); on the CPU it runs eagerly;
4. **retirement** — finished rows give their pages back.

Every row attends only over its own ``[0, cache_len)`` and its pages are
exclusively owned, so a stream is token-identical to the same request
decoded alone, greedy or sampled: a sampled row draws from its own key
``fold_in(PRNGKey(seed), rid)`` (:mod:`repro_torch.prng`, bit-identical
to ``jax.random``), split once per emitted token.

**Fault tolerance**, as in the reference: a bounded queue REJECTS past
``max_queue``; :meth:`cancel` and ``deadline_ticks`` end requests at a
chunk boundary; the guard quarantines a row whose logits go non-finite;
``PrefixIndex.verify()`` drops a corrupted index; a chunk that raises
restores the host snapshot taken before it, degrades the engine to
single-tick chunks and gives up after ``max_chunk_failures``
consecutive failures.  A chunk that raises after it started running on
a stack with recurrent layers cannot be restored (it advanced their
state in place): the engine raises, as the reference does when a
failure outlived its donated caches.  A seeded
:class:`~repro_torch.serving.faults.FaultInjector` drives all of it.  The writes an aborted chunk made sit at
positions at or past each row's restored ``cache_len``: nobody attends
them and the retry overwrites them.  The port's caches are updated in
place, so the reference's check that a donated cache buffer survived the
failure has no counterpart here.  A CUDA graph that fails to capture or
replay is not such a chunk failure, nor is one of an admission
prefill: it raises out of ``step``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch import prng, tracing
from repro_torch.analysis import runtime as analysis_runtime
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (_check_ported, _select_token_rows,
                                            init_caches, lm_decode, lm_prefill)

from .graphs import GraphFailure, PackedGraphs, pool_reserved_bytes
from .pages import NULL_PAGE, PagePool, PrefixIndex
from .scheduler import Request, RequestStatus, Scheduler
from .slo import AdaptiveChunkPolicy, ChunkSignals, percentiles

__all__ = ["ServingEngine"]


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: List[int]
    emitted: List[int]


@torch.no_grad()
def _paged_prefill_step(params, caches, packed, *, cfg, max_pages, fresh_rows,
                        scratch_rows, start=0, guard=True):
    """Paged prefill-on-join of one prompt (tail) straight into the pool
    pages its page-table row names, over ONE packed int32 input: the
    (1, L) tokens, the slot's (1, ``max_pages``) table row and the slot
    index (L is the input's length less ``max_pages + 1``).  A recurrent
    layer prefills into its one-row scratch cache in ``scratch_rows``,
    reset from ``fresh_rows`` (the initial state) here, and the final
    state is written to row ``slot`` of the pool with an ``index_copy_``
    whose index is read on the device, so one graph serves every slot.
    ``start > 0`` is the prefix-cache tail at logical positions
    ``[start, start+L)``.  Static: ``(L, start, guard)``, the reference's
    static arguments.  Returns ONE packed int32 block (2,): the first
    token and the all-finite flag (1 without ``guard``)."""
    n = packed.shape[0] - max_pages - 1
    tokens = packed[:n].view(1, n)
    table = packed[n:n + max_pages].view(1, max_pages)
    slot = packed[n + max_pages:].long()
    pre = []
    for cache, fresh, scratch in zip(caches, fresh_rows, scratch_rows):
        if scratch is None:                    # attention: the page pool
            pre.append(cache)
            continue
        for k, t in scratch.items():
            t.copy_(fresh[k])
        pre.append(scratch)
    logits, _ = lm_prefill(params, pre,
                           {"tokens": tokens, "page_tables": table}, cfg,
                           start_pos=start)
    for cache, scratch in zip(caches, scratch_rows):
        if scratch is not None:
            for k, t in cache.items():
                t.index_copy_(0, slot, scratch[k])
    last = logits[:, -1]
    first = torch.argmax(last, dim=-1).to(torch.int32)
    ok = (torch.isfinite(last).all() if guard
          else torch.ones((), dtype=torch.bool, device=last.device))
    return torch.cat([first, ok.to(torch.int32)[None]])


@torch.no_grad()
def _decode_chunk(params, caches, tok, cache_len, tables, rngs, temperature,
                  top_k, top_p, budget_left, *, cfg, ticks, eos_id, sampled,
                  guard):
    """``ticks`` batched decode steps, all on the device, no host sync.

    A row freezes the moment it emits ``eos_id`` or exhausts
    ``budget_left``: it keeps its token, ``cache_len`` and key for the
    rest of the chunk and its lockstep output is discarded (its page
    writes land at its frozen ``cache_len``, attended by nobody).
    Sampling params are ``(B,)`` vectors and keys ``(B, 2)``; keys advance
    only on live sampled rows.  ``sampled=False`` (no slot has
    temperature > 0) is the argmax-only variant.  With ``guard`` a row
    whose logits go non-finite freezes at that tick and is flagged
    ``bad``.  The reference skips the decode body once every row is
    done; here the loop runs all ``ticks`` (a captured graph has no
    branch on device values) — the extra steps change no emitted token.

    Returns (tokens (ticks, B), emitted counts (B,), bad (B,), last tok
    (B, 1), cache_len (B,), keys (B, 2)), all on the device."""
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
        if sampled:
            nxt, rngs2 = _select_token_rows(last, rngs, temperature, top_k,
                                            top_p)
        else:
            nxt, rngs2 = torch.argmax(last, dim=-1).to(torch.int32), rngs
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
        rngs = torch.where(live[:, None], rngs2, rngs)
        tok = torch.where(live[:, None], nxt[:, None], tok)
        emits.append(emit)
        lives.append(live)
    toks = torch.stack(emits)
    counts = torch.stack(lives).sum(dim=0, dtype=torch.int32)
    return toks, counts, bad, tok, cache_len, rngs


def _chunk_label(variant) -> str:
    ticks, sampled = variant
    return f"{ticks}/{'sampled' if sampled else 'greedy'}"


def _prefill_label(variant) -> str:
    length, start, _ = variant
    return f"{length}@{start}"


# rows of the packed int32 chunk input, each (B,) but the (B, max_pages)
# tables and the (B, 2) keys; floats travel by their bits
_IN_ROWS = ("tok", "cache_len", "tables", "rngs", "temperature", "top_k",
            "top_p", "budget_left")


def _in_widths(max_pages: int) -> Dict[str, int]:
    return {name: {"tables": max_pages, "rngs": 2}.get(name, 1)
            for name in _IN_ROWS}


def _decode_chunk_packed(params, caches, packed, *, cfg, num_slots, max_pages,
                         ticks, eos_id, sampled, guard):
    """:func:`_decode_chunk` over ONE packed int32 input buffer (see
    ``ServingEngine._pack_inputs``), returning ONE packed int32 block of
    ``ticks + 6`` rows of B: the tokens, emitted counts, bad flags, last
    token, cache_len and the two key words — the single host transfer."""
    b, parts, off = num_slots, {}, 0
    for name, w in _in_widths(max_pages).items():
        parts[name] = packed[off:off + b * w].view(b, w)
        off += b * w
    toks, counts, bad, tok, clen, rngs = _decode_chunk(
        params, caches, parts["tok"], parts["cache_len"][:, 0],
        parts["tables"], prng.from_uint32_words(parts["rngs"]),
        parts["temperature"][:, 0].view(torch.float32), parts["top_k"][:, 0],
        parts["top_p"][:, 0].view(torch.float32), parts["budget_left"][:, 0],
        cfg=cfg, ticks=ticks, eos_id=eos_id, sampled=sampled, guard=guard)
    return torch.cat([toks, counts[None], bad.to(torch.int32)[None], tok.T,
                      clen.to(torch.int32)[None],
                      prng.to_uint32_words(rngs).T])


class ServingEngine:
    """Request-level serving: paged KV pool + continuous batching.

    Parameters
    ----------
    params : dense or BSR-packed params tree (both serve through
        ``models/layers.matmul``).
    cfg : model config: attention, Mamba, mLSTM and sLSTM mixers, dense,
        MoE or no MLP (no SWA).
    num_slots : decode-batch rows.
    page_size : tokens per physical KV page.
    max_seq_len : longest prompt + generation a request may hold.
    num_pages : physical pages per layer pool (page 0 is the null page);
        defaults to every slot holding a full-length sequence.
    ticks_per_sync : decode steps between two scheduler events (with a
        ``chunk_policy``, only the degraded-mode baseline).
    chunk_policy : optional :class:`~repro_torch.serving.slo.
        AdaptiveChunkPolicy` picking each chunk's length from its declared
        levels from host mirrors only; streams do not change with it.
    aging_ticks : queue wait that promotes a request one priority level
        (None disables aging).
    temperature / top_k / top_p : engine-wide sampling defaults, each
        overridable per request at :meth:`submit`.
    eos_id : stop token.
    seed : base of the per-request keys ``fold_in(PRNGKey(seed), rid)``.
    prefix_caching : share page-aligned prompt-prefix K/V across requests;
        off by construction when any mixer is not attention.
    max_queue : bound on the waiting queue; a submit past it is REJECTED.
    nan_guard : freeze and fail rows whose logits go non-finite.
    max_chunk_failures : consecutive decode-chunk exceptions tolerated
        (snapshot restore + degraded single-tick retry) before giving up.
    fault_injector : optional :class:`~repro_torch.serving.faults.
        FaultInjector` consulted at the chunk-boundary hooks.
    device : the card by default; ``"cpu"`` runs the plain versions.
    cuda_graphs : run each decode chunk as a CUDA graph captured once per
        ``(ticks, sampled)`` variant and each admission prefill as one
        captured once per ``(L, start, guard)`` (default: on a CUDA
        device).  False runs both eagerly; the CPU always does.
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
        chunk_policy: Optional[AdaptiveChunkPolicy] = None,
        aging_ticks: Optional[int] = 32,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        seed: int = 0,
        prefix_caching: bool = True,
        max_queue: Optional[int] = None,
        nan_guard: bool = True,
        max_chunk_failures: int = 3,
        fault_injector=None,
        device=None,
        cuda_graphs: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        if cfg.window is not None:
            raise ValueError("paged KV caches do not support SWA windows")
        if cfg.enc_layers:
            raise ValueError("encoder-decoder archs are not paged-servable")
        self._specs = _check_ported(cfg)
        if ticks_per_sync < 1:
            raise ValueError("ticks_per_sync must be >= 1")
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs needs a CUDA device, not {self.device}")
        self.params, self.cfg = params, cfg
        self.num_slots = num_slots
        self.ticks_per_sync = ticks_per_sync
        self.configured_ticks_per_sync = ticks_per_sync
        self.chunk_policy = chunk_policy
        self.max_pages = -(-max_seq_len // page_size)
        if num_pages is None:
            num_pages = num_slots * self.max_pages + 1
        self.pool = PagePool(num_pages, page_size)
        self._attn = [spec.mixer == "attn" for spec in self._specs]
        self.prefix_caching = bool(prefix_caching) and all(self._attn)
        self.prefix_index = PrefixIndex(self.pool) if self.prefix_caching else None
        self.scheduler = Scheduler(self.pool, self.prefix_index,
                                   max_queue=max_queue, aging_ticks=aging_ticks)
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.eos_id = eos_id
        self.nan_guard = bool(nan_guard)
        self.max_chunk_failures = max_chunk_failures
        self.injector = fault_injector
        self._base_key = prng.PRNGKey(seed)        # host: keys fold in there
        # prefix-cache observability (see prefix_stats)
        self.prefix_lookups = 0
        self.prefix_hit_requests = 0
        self.prefix_pages_shared = 0
        # fault-tolerance observability (see fault_stats)
        self.rejected = 0
        self.cancelled = 0
        self.expired = 0
        self.failed = 0
        self.guard_trips = 0
        self.chunk_failures = 0
        self.alloc_failures = 0
        self.index_drops = 0
        self.queue_high_water = 0
        self.degraded = False
        # adaptive-chunking observability (see slo_stats)
        self.chunks_by_ticks: Dict[int, int] = {}
        self.chunk_shrinks = 0
        self.chunk_grows = 0
        self._last_chunk_ticks: Optional[int] = None
        self.last_chunk_error: Optional[str] = None
        self._consec_chunk_failures = 0
        self._cancel_pending: Set[int] = set()
        self._step_progress = False   # terminal/retry event this step

        # attention layers: page pools; recurrent layers: one row per slot
        # (their state is O(1) per sequence), the initial row an admission
        # starts from and the one-row scratch cache it prefills into
        shape = (num_pages, page_size, cfg.kv_heads, cfg.head_dim_())
        rows = init_caches(cfg, num_slots, 1, torch.float32, self.device)
        self.caches = [
            {"k": torch.zeros(shape, dtype=torch.float32, device=self.device),
             "v": torch.zeros(shape, dtype=torch.float32, device=self.device)}
            if attn else row for attn, row in zip(self._attn, rows)]

        def one_row():
            return [None if attn else row for attn, row in zip(
                self._attn, init_caches(cfg, 1, 1, torch.float32, self.device))]

        self._fresh_rows, self._scratch_rows = one_row(), one_row()

        # host-mirrored per-slot state, pushed to the device every chunk
        self._tok = np.zeros((num_slots, 1), np.int32)
        self._cache_len = np.zeros((num_slots,), np.int32)
        self._tables = np.full((num_slots, self.max_pages), NULL_PAGE, np.int32)
        self._rngs = np.zeros((num_slots, 2), np.uint32)
        self._temp = np.zeros((num_slots,), np.float32)
        self._topk = np.zeros((num_slots,), np.int32)      # 0: disabled
        self._topp = np.ones((num_slots,), np.float32)     # 1: disabled
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        self.requests: Dict[int, Request] = {}
        self.tick = 0
        self._next_rid = 0
        self.active_slot_ticks = 0
        self.decode_ticks = 0
        # wall clock at which each request was first due (arrival reached)
        self.due_time: Dict[int, float] = {}
        # declared host round-trips: one per chunk, one per admission
        self.sync_regions: Dict[str, int] = {"admission": 0, "decode_chunk": 0}
        self.admissions_by_slot = [0] * num_slots
        # one graph memory pool for the chunks and the prefills
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda_graphs else None
        n_in = num_slots * sum(_in_widths(self.max_pages).values())
        self.graphs = (PackedGraphs(self._chunk_fn, n_in, self.device,
                                    region="decode_chunk", label=_chunk_label,
                                    pool=self._graph_pool)
                       if cuda_graphs else None)
        n_prefill = self.max_pages * page_size + self.max_pages + 1
        self.prefill_graphs = (PackedGraphs(self._prefill_fn, n_prefill,
                                            self.device, region="admission",
                                            label=_prefill_label,
                                            pool=self._graph_pool)
                               if cuda_graphs else None)

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, max_new: int, arrival: int = 0, *,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               deadline_ticks: Optional[int] = None,
               priority: int = 0,
               ttft_target_ticks: Optional[int] = None,
               tpot_target_ticks: Optional[int] = None) -> int:
        """Queue a request and return its rid.  Sampling params default to
        the engine's; ``deadline_ticks`` expires the request unfinished at
        ``arrival + deadline_ticks``; ``priority`` (lower = more urgent)
        orders admission; ``ttft_target_ticks``/``tpot_target_ticks`` are
        soft targets the adaptive policy steers by and :meth:`slo_stats`
        counts misses of.  Past a bounded queue the request is REJECTED
        (terminal at once)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new < 1 or prompt.size < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        oob = np.nonzero((prompt < 0) | (prompt >= self.cfg.vocab))[0]
        if oob.size:
            pos = int(oob[0])
            raise ValueError(
                f"prompt token id {int(prompt[pos])} at position {pos} is "
                f"outside [0, {self.cfg.vocab}); out-of-range ids would "
                f"silently gather garbage embedding rows")
        if deadline_ticks is not None and deadline_ticks < 1:
            raise ValueError("deadline_ticks must be >= 1 (or None)")
        if ttft_target_ticks is not None and ttft_target_ticks < 1:
            raise ValueError("ttft_target_ticks must be >= 1 (or None)")
        if tpot_target_ticks is not None and tpot_target_ticks < 1:
            raise ValueError("tpot_target_ticks must be >= 1 (or None)")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      arrival=arrival, temperature=temperature,
                      top_k=top_k, top_p=top_p,
                      deadline_ticks=deadline_ticks, priority=priority,
                      ttft_target_ticks=ttft_target_ticks,
                      tpot_target_ticks=tpot_target_ticks)
        if self.pool.pages_for(req.budget_tokens) > self.max_pages:
            raise ValueError(
                f"request needs {req.budget_tokens} tokens > "
                f"max_seq_len {self.max_pages * self.pool.page_size}")
        self._next_rid += 1
        self.requests[req.rid] = req
        if tracing.enabled():
            req.queued_ns = time.time_ns()
        if self.scheduler.submit(req):
            self.queue_high_water = max(self.queue_high_water,
                                        self.scheduler.pending)
        else:
            self.rejected += 1
        return req.rid

    def cancel(self, rid: int) -> RequestStatus:
        """Cancel a request: a waiting one leaves the queue at once
        (CANCELLED, no tokens); an active one is released at the next
        chunk boundary keeping its tokens.  A no-op on a terminal request.
        Returns the status as of this call."""
        req = self.requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid}")
        if req.terminal:
            return req.status
        waiting = self.scheduler.remove(rid)
        if waiting is not None:
            self.scheduler.finish_waiting(
                waiting, self.tick, RequestStatus.CANCELLED,
                reason="cancelled while queued")
            self.cancelled += 1
            return RequestStatus.CANCELLED
        self._cancel_pending.add(rid)
        return req.status

    def sampling_for(self, req: Request):
        """The effective (temperature, top_k, top_p) a request decodes
        with, for solo-decode verifiers."""
        t = req.temperature if req.temperature is not None else self.temperature
        k = req.top_k if req.top_k is not None else self.top_k
        p = req.top_p if req.top_p is not None else self.top_p
        return (float(t or 0.0), k, p)

    def request_key(self, rid: int) -> torch.Tensor:
        """The (2,) key request ``rid`` samples from."""
        return prng.fold_in(self._base_key, rid)

    # -- engine loop -------------------------------------------------------

    def _admit(self) -> int:
        free = [i for i, s in enumerate(self.slots) if s is None]
        admitted = self.scheduler.admit(self.tick, len(free))
        # pages promised to this batch's admissions: eviction below must
        # never reclaim a page a sibling's reservation counted on
        pins: Set[int] = set()
        if self.prefix_index is not None:
            for req in admitted:
                pins.update(self.prefix_index.match(req.prompt))
        count = 0
        for j, req in enumerate(admitted):
            with tracing.span("request.admit", rid=req.rid) as sp:
                if req.queued_ns is not None:
                    tracing.add("request.queue", req.queued_ns, sp.start,
                                rid=req.rid)
                slot = free[0]
                hits: List[int] = []
                if self.prefix_index is not None:
                    self.prefix_lookups += 1
                    hits = self.prefix_index.match(req.prompt)
                n_hit = len(hits)
                total = self.pool.pages_for(req.budget_tokens)
                need = total - n_hit
                short = need - self.pool.free_pages
                if self.prefix_index is not None and short > 0:
                    self.prefix_index.evict(short, exclude=pins | set(hits))
                try:
                    if self.injector is not None:
                        self.injector.on_alloc(self, need)
                    fresh = self.pool.alloc_pages(need)
                except RuntimeError:
                    # nothing of this request is committed yet: requeue it
                    # and the rest of the batch in order, retry at a later
                    # boundary
                    self.alloc_failures += 1
                    self._step_progress = True
                    self.scheduler.requeue(admitted[j:])
                    break
                free.pop(0)
                self.pool.share(hits)                 # map, don't recompute
                pages = hits + fresh
                self._tables[slot] = NULL_PAGE
                self._tables[slot, :total] = pages
                # the prefill: one packed upload (tail tokens, the slot's
                # table row, the slot) and ONE declared host round-trip (first
                # token, guard flag and the request's decode key, folded on
                # the host); on the card a graph replay of its (L, start,
                # guard) variant
                start = n_hit * self.pool.page_size
                tail = req.prompt[start:]
                packed = np.concatenate([tail, self._tables[slot],
                                         np.asarray([slot], np.int32)])
                if self.prefill_graphs is not None:
                    first_ok, key = self.prefill_graphs.run(
                        packed, (tail.size, start, self.nan_guard),
                        within=functools.partial(self._key_words, req.rid))
                else:
                    with tracing.span("graphs.run", arg="admission"):
                        out = _paged_prefill_step(
                            self.params, self.caches, self._upload(packed),
                            cfg=self.cfg, max_pages=self.max_pages,
                            fresh_rows=self._fresh_rows,
                            scratch_rows=self._scratch_rows, start=start,
                            guard=self.nan_guard)
                        with analysis_runtime.sync_region("admission"):
                            first_ok, key = (out.cpu().numpy(),
                                             self._key_words(req.rid))
                self.sync_regions["admission"] += 1
                self.admissions_by_slot[slot] += 1
                if self.nan_guard and not bool(first_ok[1]):
                    self.guard_trips += 1
                    self.failed += 1
                    self._step_progress = True
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
                self._rngs[slot] = key
                t, k, p = self.sampling_for(req)
                self._temp[slot] = t
                self._topk[slot] = k if k is not None else 0
                self._topp[slot] = p if p is not None else 1.0
                req.admitted_at = self.tick
                req.status = RequestStatus.ACTIVE
                self.slots[slot] = _Slot(req=req, pages=pages, emitted=[tok])
                count += 1
                self._maybe_finish(slot)
        return count

    def _prefill_fn(self, packed: torch.Tensor, length: int, start: int,
                    guard: bool) -> torch.Tensor:
        return _paged_prefill_step(
            self.params, self.caches, packed, cfg=self.cfg,
            max_pages=self.max_pages, fresh_rows=self._fresh_rows,
            scratch_rows=self._scratch_rows, start=start, guard=guard)

    def _key_words(self, rid: int) -> np.ndarray:
        """Request ``rid``'s key as two uint32 words on the host."""
        return self.request_key(rid).numpy().astype(np.uint32)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device.  On the card it goes
        through pinned memory without blocking the host: a pageable copy
        waits for the card, a host sync that ``no_host_sync`` refuses."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

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
                for c, attn in zip(self.caches, self._attn):
                    if attn:
                        c["k"][new] = c["k"][pid]
                        c["v"][new] = c["v"][pid]
                self._tables[i, idx] = new
                s.pages[s.pages.index(pid)] = new

    # -- lifecycle transitions ---------------------------------------------

    def _release_slot(self, i: int, status: RequestStatus,
                      reason: Optional[str] = None) -> None:
        """Terminal transition of an active slot: keep the tokens emitted
        so far, reset the slot's mirrors and hand the pages back (FAILED
        rows also purge their pages from the prefix index)."""
        s = self.slots[i]
        s.req.tokens = np.asarray(s.emitted, np.int32)
        s.req.finished_time = time.perf_counter()
        if status is RequestStatus.FAILED and self.prefix_index is not None:
            self.prefix_index.drop_pages(s.pages)
        self.slots[i] = None
        self._tables[i] = NULL_PAGE
        self._cache_len[i] = 0
        self._tok[i, 0] = 0
        self._temp[i], self._topk[i], self._topp[i] = 0.0, 0, 1.0
        self.scheduler.retire(s.req, s.pages, self.tick, status=status,
                              reason=reason)

    def _maybe_finish(self, slot: int) -> None:
        s = self.slots[slot]
        if s is None:
            return
        if (len(s.emitted) >= s.req.max_new
                or (self.eos_id is not None and s.emitted[-1] == self.eos_id)):
            self._release_slot(slot, RequestStatus.FINISHED)

    def _service_cancels(self) -> None:
        """Honor pending cancels at the chunk boundary."""
        if not self._cancel_pending:
            return
        for i, s in enumerate(self.slots):
            if s is not None and s.req.rid in self._cancel_pending:
                self._cancel_pending.discard(s.req.rid)
                self.cancelled += 1
                self._step_progress = True
                self._release_slot(
                    i, RequestStatus.CANCELLED,
                    reason="cancelled mid-stream at chunk boundary")
        self._cancel_pending = {
            rid for rid in self._cancel_pending
            if not self.requests[rid].terminal}

    def _service_deadlines(self) -> None:
        """Expire overdue requests, waiting (no tokens) or active (keeping
        their partial stream)."""
        for _ in self.scheduler.expire(self.tick):
            self.expired += 1
            self._step_progress = True
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            dl = s.req.deadline
            if dl is not None and self.tick >= dl:
                self.expired += 1
                self._step_progress = True
                self._release_slot(
                    i, RequestStatus.EXPIRED,
                    reason=f"deadline (tick {dl}) passed mid-stream")

    def _verify_index(self) -> None:
        """Prefix-index self-check: on any inconsistency drop the whole
        cache by its reference ledger and keep serving uncached."""
        if self.prefix_index is None:
            return
        if self.prefix_index.verify():
            self.prefix_index.clear()
            self.index_drops += 1
            self._step_progress = True

    # -- crash-consistent stepping -----------------------------------------

    def _snapshot(self):
        """Copies of every host-mirrored slot vector: the restore point
        if the chunk raises."""
        return (self._tok.copy(), self._cache_len.copy(),
                self._tables.copy(), self._rngs.copy(), self._temp.copy(),
                self._topk.copy(), self._topp.copy())

    def _restore(self, snap) -> None:
        (self._tok, self._cache_len, self._tables, self._rngs,
         self._temp, self._topk, self._topp) = (a.copy() for a in snap)

    def _recover_chunk_failure(self, snap, err: Exception) -> None:
        """A decode chunk raised: restore the snapshot, degrade to
        single-tick chunks and retry on the next step; after more than
        ``max_chunk_failures`` consecutive failures, give up loudly."""
        self._restore(snap)
        self.chunk_failures += 1
        self._consec_chunk_failures += 1
        self._step_progress = True
        self.last_chunk_error = repr(err)
        if not self.degraded:
            self.degraded = True
            self.ticks_per_sync = 1       # smallest replayable unit
        if self._consec_chunk_failures > self.max_chunk_failures:
            raise RuntimeError(
                f"{self._consec_chunk_failures} consecutive decode-chunk "
                f"failures (last: {self.last_chunk_error}); giving up: "
                f"{self._state()}") from err

    # -- adaptive chunk length ---------------------------------------------

    def _chunk_signals(self, active: List[int]) -> ChunkSignals:
        """The chunk policy's inputs, from host mirrors only."""
        tick = self.tick
        queue_depth = sum(
            1 for r in self.scheduler.waiting if r.arrival <= tick)
        slack = None
        headroom = None
        for i in active:
            s = self.slots[i]
            left = s.req.max_new - len(s.emitted)
            slack = left if slack is None else min(slack, left)
            dl = s.req.deadline
            if dl is not None:
                h = max(1, dl - tick)
                headroom = h if headroom is None else min(headroom, h)
            tp = s.req.tpot_target_ticks
            if tp is not None:
                headroom = tp if headroom is None else min(headroom, tp)
        next_arrival = None
        for r in self.scheduler.waiting:
            if r.arrival > tick:
                d = r.arrival - tick
                next_arrival = (d if next_arrival is None
                                else min(next_arrival, d))
                continue
            if r.ttft_target_ticks is not None:
                h = max(1, r.arrival + r.ttft_target_ticks - tick)
                headroom = h if headroom is None else min(headroom, h)
        return ChunkSignals(tick=tick, queue_depth=queue_depth,
                            free_slots=self.num_slots - len(active),
                            min_active_slack=slack, slo_headroom=headroom,
                            next_arrival_in=next_arrival)

    def _next_ticks(self, active: List[int]) -> int:
        """The next chunk's length: ``ticks_per_sync`` without a policy or
        once degraded, else the policy's pick (one of its levels)."""
        if self.chunk_policy is None or self.degraded:
            return self.ticks_per_sync
        return self.chunk_policy.next_ticks(self._chunk_signals(active))

    def _count_chunk(self, ticks: int) -> None:
        """Record a COMMITTED chunk length and the shrink/grow transition
        against the previous committed one."""
        self.chunks_by_ticks[ticks] = self.chunks_by_ticks.get(ticks, 0) + 1
        prev = self._last_chunk_ticks
        if prev is not None:
            if ticks < prev:
                self.chunk_shrinks += 1
            elif ticks > prev:
                self.chunk_grows += 1
        self._last_chunk_ticks = ticks

    # -- the chunk ----------------------------------------------------------

    def _pack_inputs(self, left: np.ndarray) -> np.ndarray:
        """Every host mirror the chunk reads, as ONE int32 vector in
        ``_IN_ROWS`` order (floats and keys by their bits)."""
        return np.concatenate([
            self._tok.reshape(-1), self._cache_len, self._tables.reshape(-1),
            self._rngs.view(np.int32).reshape(-1),
            self._temp.view(np.int32), self._topk,
            self._topp.view(np.int32), left]).astype(np.int32, copy=False)

    def _chunk_fn(self, packed: torch.Tensor, ticks: int,
                  sampled: bool) -> torch.Tensor:
        return _decode_chunk_packed(
            self.params, self.caches, packed, cfg=self.cfg,
            num_slots=self.num_slots, max_pages=self.max_pages, ticks=ticks,
            eos_id=self.eos_id, sampled=sampled, guard=self.nan_guard)

    def _run_chunk(self, packed: np.ndarray, ticks: int,
                   sampled: bool) -> np.ndarray:
        """One chunk: a graph replay on the card, else eager; either way
        one copy in and ONE device-to-host transfer out."""
        if self.graphs is not None:
            return self.graphs(packed, ticks, sampled)
        out = self._chunk_fn(self._upload(packed), ticks, sampled)
        with analysis_runtime.sync_region("decode_chunk"):
            return out.cpu().numpy()

    def step(self) -> int:
        """One scheduler event: fault/lifecycle servicing, admission, then
        ONE decode chunk.  Returns the requests admitted."""
        with tracing.span("engine.step") as sp:
            return self._step_phases(sp)

    def _step_phases(self, sp) -> int:
        """``step``'s body, in its phases' spans; ``sp`` is the step's."""
        self._step_progress = False
        with tracing.span("engine.service"):
            now = time.perf_counter()
            for r in self.scheduler.waiting:
                if r.arrival <= self.tick:
                    self.due_time.setdefault(r.rid, now)
            if self.injector is not None:
                self.injector.on_step_start(self)
            self._verify_index()
            self._service_cancels()
            self._service_deadlines()
        with tracing.span("engine.admit"):
            admitted = self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self.tick += 1
            return admitted
        sp.set_arg(len(active))
        with tracing.span("engine.prepare"):
            ticks = self._next_ticks(active)
            self._cow_guard(active, ticks)
            left = np.zeros((self.num_slots,), np.int32)
            for i in active:
                left[i] = self.slots[i].req.max_new - len(self.slots[i].emitted)
            snap = self._snapshot()
            packed_in = self._pack_inputs(left)
            sampled = bool(np.any(self._temp > 0.0))
        started = False
        try:
            with tracing.span("engine.chunk"):
                if self.injector is not None:
                    self.injector.on_chunk_start(self, active, ticks)
                started = True
                packed = self._run_chunk(packed_in, ticks, sampled)
        except GraphFailure:
            raise
        except Exception as err:
            if started and not all(self._attn):
                raise RuntimeError(
                    "decode chunk failed after it advanced the recurrent "
                    "state in place; engine state is unrecoverable") from err
            self._recover_chunk_failure(snap, err)
            self.tick += 1
            return admitted
        with tracing.span("engine.commit"):
            self._commit(packed, active, ticks)
        return admitted

    def _commit(self, packed: np.ndarray, active: List[int], ticks: int) -> None:
        """A chunk's outputs back into the host mirrors and the slots:
        emitted tokens, finished and quarantined rows retired."""
        self._consec_chunk_failures = 0
        self.sync_regions["decode_chunk"] += 1
        toks, counts, bad = packed[:ticks], packed[ticks], packed[ticks + 1]
        self._tok = packed[ticks + 2][:, None].copy()
        self._cache_len = packed[ticks + 3].copy()
        self._rngs = np.ascontiguousarray(packed[ticks + 4:ticks + 6].T).view(
            np.uint32)
        for i in active:
            self.slots[i].emitted.extend(int(t) for t in toks[:int(counts[i]), i])
            if bad[i]:
                self.guard_trips += 1
                self.failed += 1
                self._step_progress = True
                self._release_slot(
                    i, RequestStatus.FAILED,
                    reason="non-finite decode logits (quarantined)")
            else:
                self._maybe_finish(i)
        self.active_slot_ticks += int(counts.sum())
        self.decode_ticks += ticks
        self.tick += ticks
        self._count_chunk(ticks)

    # -- observability -------------------------------------------------------

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

    @property
    def fault_stats(self) -> Dict[str, int]:
        """Fault-tolerance counters under the reference's names
        (``max_queue`` 0 means unbounded)."""
        return {
            "nan_guard": int(self.nan_guard),
            "queue_depth": self.scheduler.pending,
            "queue_high_water": self.queue_high_water,
            "max_queue": self.scheduler.max_queue or 0,
            "rejected": self.rejected,
            "cancelled": self.cancelled,
            "expired": self.expired,
            "failed": self.failed,
            "guard_trips": self.guard_trips,
            "chunk_failures": self.chunk_failures,
            "alloc_failures": self.alloc_failures,
            "index_drops": self.index_drops,
            "degraded": int(self.degraded),
        }

    def slo_stats(self) -> Dict[str, object]:
        """Adaptive-chunking counters (the declared chunk levels, committed
        chunk lengths, shrinks and grows) and, per priority class over the
        terminal requests that held a slot, TTFT p50/p99 in ticks and the
        mean ticks per token after the first, plus soft-target misses."""
        policy = self.chunk_policy
        ttft_miss = tpot_miss = 0
        by_prio: Dict[int, Dict[str, List[float]]] = {}
        for r in self.scheduler.finished:
            ttft_miss += int(r.ttft_missed)
            tpot_miss += int(r.tpot_missed)
            if r.admitted_at is None:
                continue
            cls = by_prio.setdefault(r.priority, {"ttft": [], "tpot": []})
            cls["ttft"].append(float(r.ttft_ticks))
            tpot = r.tpot_ticks
            if tpot is not None:
                cls["tpot"].append(float(tpot))
        classes = {}
        for prio in sorted(by_prio):
            cls = by_prio[prio]
            pct = percentiles(cls["ttft"])
            classes[prio] = {
                "requests": len(cls["ttft"]),
                "ttft_ticks_p50": pct["p50"],
                "ttft_ticks_p99": pct["p99"],
                "tpot_ticks_mean": (float(np.mean(cls["tpot"]))
                                    if cls["tpot"] else 0.0),
            }
        return {
            "adaptive": int(policy is not None),
            "chunk_levels": list(policy.compile_levels) if policy is not None
            else [self.configured_ticks_per_sync],
            "chunks_by_ticks": dict(sorted(self.chunks_by_ticks.items())),
            "chunk_shrinks": self.chunk_shrinks,
            "chunk_grows": self.chunk_grows,
            "aging_ticks": self.scheduler.aging_ticks or 0,
            "ttft_target_misses": ttft_miss,
            "tpot_target_misses": tpot_miss,
            "by_priority": classes,
        }

    def analysis_stats(self) -> Dict[str, object]:
        """Runtime counters behind "nothing new is captured in steady
        state, one declared transfer per chunk and per admission", under
        the reference's names: the compile caches of the two hot-path
        entry points (the captured ``(ticks, sampled)`` variants of
        ``_decode_chunk`` and ``(L, start, guard)`` variants of
        ``_paged_prefill_step``; -1 for each when it runs eagerly), the
        process-wide count of graph captures and kernel library loads,
        and the declared host sync regions (one ``decode_chunk`` per
        chunk, one ``admission`` per admitted request); beside them
        whether the steps run as CUDA graphs, each chunk variant's
        capture seconds, replays and launches per replay, the same for
        the prefill variants (``"<L>@<start>"``) under ``prefill_``
        names, the admissions per slot and the bytes the graphs' memory
        pool holds (None where not measured)."""
        empty = {"captures": 0, "variants": []}
        graphs = self.graphs.stats() if self.graphs is not None else empty
        prefill = (self.prefill_graphs.stats()
                   if self.prefill_graphs is not None else empty)
        return {
            "compile_caches": {
                "_decode_chunk": analysis_runtime.cache_size(self.graphs),
                "_paged_prefill_step": analysis_runtime.cache_size(
                    self.prefill_graphs),
            },
            "compile_events": analysis_runtime.compile_events(),
            "sync_regions": dict(self.sync_regions),
            "cuda_graphs": int(self.graphs is not None), **graphs,
            **{f"prefill_{k}": v for k, v in prefill.items()},
            "admissions_by_slot": list(self.admissions_by_slot),
        }

    def graph_pool_bytes(self) -> Optional[int]:
        """Bytes reserved in the graphs' shared memory pool (None on the
        CPU, or where the allocator's snapshot does not name pools)."""
        if self._graph_pool is None:
            return None
        return pool_reserved_bytes(self._graph_pool, self.device)

    def release_prefix_cache(self) -> int:
        """Drop every cached prefix block; pages still mapped by active
        requests survive on their own references.  Returns entries
        released."""
        if self.prefix_index is None:
            return 0
        return self.prefix_index.clear()

    def _state(self) -> str:
        """One-line engine state for stall diagnostics."""
        waiting = [(r.rid, r.budget_tokens, self.scheduler.pages_needed(r),
                    r.arrival, r.priority) for r in self.scheduler.waiting]
        active = [(s.req.rid, len(s.emitted), s.req.max_new)
                  for s in self.slots if s is not None]
        return (f"tick={self.tick} "
                f"waiting(rid,budget_tok,pages,arrival,prio)={waiting} "
                f"active(rid,emitted,max_new)={active} "
                f"pool={self.pool.free_pages}/{self.pool.num_pages - 1} "
                f"pages free (page_size={self.pool.page_size}, "
                f"max {self.max_pages} pages/request) "
                f"prefix_cache={self.prefix_stats} "
                f"faults={self.fault_stats}")

    def run(self, max_ticks: int = 100_000) -> Dict[int, Request]:
        """Drive chunks until every submitted request is terminal; returns
        every terminal request by rid (check ``.status``)."""
        while self.scheduler.pending or any(s is not None for s in self.slots):
            if self.tick >= max_ticks:
                raise RuntimeError(
                    f"engine stalled after {max_ticks} ticks: {self._state()}")
            # a tick that starts idle with a due request and admits
            # nothing can never progress — unless it made OTHER progress
            # (a terminal transition, an allocator retry, a recovered chunk)
            idle = all(s is None for s in self.slots)
            due = any(r.arrival <= self.tick for r in self.scheduler.waiting)
            admitted = self.step()
            if idle and due and not admitted and not self._step_progress:
                head = self.scheduler.effective_head(self.tick)
                avail = self.pool.free_pages
                if self.prefix_index is not None:
                    avail += self.prefix_index.evictable_pages()
                raise RuntimeError(
                    "admission stalled: head request "
                    f"rid={head.rid} needs "
                    f"{self.scheduler.pages_needed(head)} pages "
                    f"({head.budget_tokens} tokens) but the drained pool "
                    f"only has {avail} (incl. evictable cache); "
                    f"{self._state()}")
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
