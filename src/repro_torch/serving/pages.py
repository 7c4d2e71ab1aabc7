"""Paged KV-cache pool: fixed-size pages, per-sequence page tables,
ref-counted sharing, and a content-hash prefix index.

The physical cache for every attention layer is one pool array
``(num_pages, page_size, kv_heads, head_dim)`` shared by all sequences;
a sequence owns an ordered list of page ids (its *page table*) and its
logical positions ``[0, cache_len)`` live at
``pool[table[t // page_size], t % page_size]``.  The pool is the device
side; ``PagePool`` here is the host-side allocator that hands pages to
sequences as they join and reclaims them as they finish (DESIGN.md §9).

Attention *walks* page tables without ever materializing a
logical view, so the same physical page may appear in many tables for
free.  ``PagePool`` therefore keeps a per-page reference count:
:meth:`alloc` hands out pages at refcount 1, :meth:`share` maps an
existing page into another table, and :meth:`free` releases one
reference — the page returns to the free list only when the last holder
drops it.  :meth:`cow` implements copy-on-write claims for writers that
do not exclusively own a page.  ``PrefixIndex`` builds the sharing
policy on top: a chain-hash index over page-aligned full prompt blocks
so N requests with a common prefix prefill it once (DESIGN.md §12).

Page id 0 is reserved as the *null page*: free decode slots point their
whole table at it, so their (discarded) decode writes land in a scratch
page instead of corrupting a live sequence.
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from collections.abc import Mapping
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch import tracing

__all__ = ["NULL_PAGE", "PagePool", "PrefixIndex"]

NULL_PAGE = 0


class PagePool:
    """Free-list allocator over ``num_pages`` fixed-size pages with
    per-page reference counts.

    Pages are recycled LIFO — a page freed by a finished sequence is the
    next one handed out, keeping the working set of the physical pool as
    small as the live traffic allows.  Conservation invariant (checked
    by tests/test_page_pool_props.py every trace step):

        free_pages + #{pages with refcount > 0} == num_pages - 1
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list; page 0 (null) is never handed out
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        # per-page counts: a memoryview of an int32 array, so one count
        # reads as a Python int, and ``np.asarray`` gives the array whole
        self._ref = memoryview(np.zeros(num_pages, np.int32))
        self.ref_high_water = 0   # max refcount any page ever reached
        self.cow_copies = 0       # copy-on-write page claims served

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def refcount(self, pid: int) -> int:
        return self._ref[pid]

    def refcounts(self, pages: np.ndarray) -> np.ndarray:
        """Reference counts of the (valid) page ids in ``pages``."""
        return np.asarray(self._ref)[pages]

    def live_refs(self) -> int:
        """Total outstanding references (a shared page counts once per
        table it appears in)."""
        return int(np.asarray(self._ref).sum())

    def pages_for(self, num_tokens: int) -> int:
        """Pages needed to hold ``num_tokens`` cache slots."""
        return max(1, -(-num_tokens // self.page_size))

    def can_alloc(self, num_tokens: int) -> bool:
        return self.pages_for(num_tokens) <= len(self._free)

    def alloc(self, num_tokens: int) -> List[int]:
        """Claim pages for ``num_tokens`` slots; raises if the pool can't
        cover the request (callers gate on :meth:`can_alloc` first)."""
        return self.alloc_pages(self.pages_for(num_tokens))

    def alloc_pages(self, n: int) -> List[int]:
        """Claim ``n`` fresh pages, each at refcount 1."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        np.asarray(self._ref)[out] = 1
        if out and self.ref_high_water < 1:
            self.ref_high_water = 1
        return out

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference per page — the caller is mapping an already
        live page into another table (prefix-cache hit, index insert)."""
        for pid in pages:
            self._check_live(pid, "share")
            self._ref[pid] += 1
            if self._ref[pid] > self.ref_high_water:
                self.ref_high_water = self._ref[pid]

    def free(self, pages: Sequence[int]) -> None:
        """Release one reference per page; a page returns to the free
        list only when its last reference drops (refcount hits 0)."""
        for pid in pages:
            self._check_live(pid, "free")
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._free.append(pid)

    def cow(self, pid: int) -> int:
        """Copy-on-write claim: return a page id the caller may write.

        Exclusively owned pages (refcount 1) are returned as-is — no
        copy needed.  Shared pages transfer the caller's reference to a
        fresh page (old page refcount -1, new page refcount 1); the
        caller must copy the device contents and repoint its table.
        """
        self._check_live(pid, "cow")
        if self._ref[pid] == 1:
            return pid
        new = self.alloc_pages(1)[0]
        self._ref[pid] -= 1
        self.cow_copies += 1
        return new

    def _check_live(self, pid: int, op: str) -> None:
        if pid == NULL_PAGE:
            raise ValueError(f"cannot {op} the null page")
        if not (0 < pid < self.num_pages):
            raise ValueError(f"{op} of invalid page {pid}")
        if self._ref[pid] <= 0:
            raise ValueError(f"{op} of unreferenced page {pid} "
                             "(double free?)")


class _IndexEntry:
    """One index entry: a view onto its row of the index's arrays.  A view
    stays bound to its row: once the entry leaves the index the row may
    be reused."""
    __slots__ = ("_idx", "row")

    def __init__(self, idx: "PrefixIndex", row: int):
        self._idx = idx
        self.row = row

    @property
    def page(self) -> int:
        """Physical page holding this block's K/V."""
        return self._idx._page[self.row]

    @page.setter
    def page(self, pid: int) -> None:
        self._idx._page[self.row] = pid

    @property
    def parent(self) -> Optional[int]:
        """Chain key of the previous block (``None`` for a root)."""
        if self._idx._root[self.row]:
            return None
        return self._idx._parent[self.row]

    @parent.setter
    def parent(self, key: Optional[int]) -> None:
        self._idx._root[self.row] = key is None
        if key is not None:
            self._idx._parent[self.row] = key

    @property
    def children(self) -> int:
        """Cached continuations (leaf iff 0)."""
        return self._idx._children[self.row]

    @children.setter
    def children(self, n: int) -> None:
        self._idx._children[self.row] = n


class _Ledger(Mapping):
    """Read-only ``page -> references held`` view of the index's ledger
    arrays.  It iterates the pages it holds in the order they were taken,
    as the dict it stands for did, so :meth:`PrefixIndex.clear` returns
    pages to the pool's free list in the same order as ever."""

    def __init__(self, counts: np.ndarray, taken: np.ndarray):
        self._counts = counts
        self._taken = taken

    def __getitem__(self, page: int) -> int:
        if (isinstance(page, (int, np.integer))
                and 0 <= page < len(self._counts) and self._counts[page]):
            return int(self._counts[page])
        raise KeyError(page)

    def __iter__(self) -> Iterator[int]:
        pages = np.flatnonzero(self._counts)
        return iter(pages[np.argsort(self._taken[pages])].tolist())

    def __len__(self) -> int:
        return int(np.count_nonzero(self._counts))


class PrefixIndex:
    """Content-hash index over page-aligned full prompt-prefix blocks.

    The key of block ``i`` is a *chain* hash — ``hash((key_{i-1},
    tokens[i·ps:(i+1)·ps]))`` — so a block can only match behind its
    exact full prefix; equal page content at different positions never
    aliases.  Each entry holds ONE pool reference on its page, taken at
    :meth:`insert`: cached K/V survives the request that computed it
    (retire → readmit reuse) until evicted.

    Eviction is leaf-first LRU: only entries with no cached continuation
    (``children == 0``) and no other reference holder (refcount 1) may
    drop, so chains stay contiguous from the root and a page is never
    reclaimed while any table still maps it.  Active sharers always pin
    ancestors before descendants (matching is prefix-contiguous), so the
    evictable entries form whole subtrees and :meth:`evictable_pages` is
    exactly what leaf-first eviction can realize.

    **Fault tolerance (DESIGN.md §13).**  Alongside the entries the
    index keeps ``_owned`` — a ledger of the pool references it has
    taken, keyed by page id.  Entries are the *lookup* structure (and
    may be corrupted by bugs or bit flips); the ledger is the
    *accounting* ground truth, mutated only at ref-take/ref-release.
    :meth:`verify` cross-checks the two (plus chain links, children
    counts, and pool refcounts) and :meth:`clear` releases by ledger —
    so a corrupted index can always be dropped without leaking or
    double-freeing a single page, and the engine keeps serving without
    the cache instead of handing poisoned page ids to new tables.
    :meth:`drop_pages` quarantines entries touching a failed request's
    pages (plus their descendant chains) the same way.

    **Storage.**  ``_entries`` maps chain keys, in LRU order, to views
    onto rows of per-row columns (page, parent key and root flag, own
    key, children, live, LRU stamp), recycled through a free list and
    grown by doubling; the ledger is a per-page count column behind the
    read-only ``_owned`` mapping.  A column is a memoryview of a numpy
    array: one element reads as a Python int, and ``np.asarray`` gives
    the array, so :meth:`verify`, :meth:`evictable_pages` and the victim
    search of :meth:`evict` decide over every entry in a fixed number of
    array passes, whatever the index holds.
    """

    _COLUMNS = (("_page", np.int32), ("_parent", np.int64), ("_root", bool),
                ("_key", np.int64), ("_children", np.int32), ("_live", bool),
                ("_stamp", np.int64))

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: "OrderedDict[int, _IndexEntry]" = OrderedDict()
        # per-row columns: ``_parent`` is the parent's chain key,
        # ``_stamp`` the row's last use (LRU order)
        for name, dtype in self._COLUMNS:
            setattr(self, name, memoryview(np.zeros(64, dtype)))
        self._clock = 0
        self._top = 0                     # rows ever handed out since clear
        self._free_rows: List[int] = []
        # the ledger: refs this index holds per page, and when each held
        # page was first taken (the order ``_owned`` iterates in)
        self._owned_n = memoryview(np.zeros(pool.num_pages, np.int32))
        self._owned_at = memoryview(np.zeros(pool.num_pages, np.int64))
        self._takes = 0
        self._owned = _Ledger(np.asarray(self._owned_n),
                              np.asarray(self._owned_at))
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    # -- rows -----------------------------------------------------------------

    def _new_entry(self, key: int, page: int,
                   parent: Optional[int]) -> _IndexEntry:
        if self._free_rows:
            row = self._free_rows.pop()
        else:
            row = self._top
            self._top += 1
            if row == len(self._live):
                for name, _ in self._COLUMNS:
                    a = np.asarray(getattr(self, name))
                    setattr(self, name, memoryview(
                        np.concatenate([a, np.zeros_like(a)])))
        self._key[row] = key
        self._page[row] = page
        self._children[row] = 0
        self._live[row] = True
        entry = _IndexEntry(self, row)
        entry.parent = parent
        self._entries[key] = entry
        self._stamp_row(row)
        return entry

    def _stamp_row(self, row: int) -> None:
        self._clock += 1
        self._stamp[row] = self._clock

    def _touch(self, key: int) -> None:
        """Mark entry ``key`` most recently used."""
        self._entries.move_to_end(key)
        self._stamp_row(self._entries[key].row)

    def _remove(self, key: int) -> Optional[_IndexEntry]:
        """Drop entry ``key``: free its row, uncount it from its parent's
        children and release its page by the ledger.  Returns the parent
        entry, if the index holds it."""
        row = self._entries.pop(key).row
        self._live[row] = False
        self._free_rows.append(row)
        pe = None if self._root[row] else self._entries.get(self._parent[row])
        if pe is not None:
            self._children[pe.row] -= 1
        self._release(self._page[row])
        return pe

    @staticmethod
    def _chain_key(parent: Optional[int], block: np.ndarray) -> int:
        return hash((parent, np.ascontiguousarray(block, np.int32).tobytes()))

    def match(self, prompt: np.ndarray) -> List[int]:
        """Pages of the longest cached page-aligned *proper* prefix of
        ``prompt``, capped at ``(len-1) // page_size`` blocks so the
        uncached tail is never empty — prefill must still run at least
        one token to produce the first-token logits, and every position
        the request will ever write (tail + decode) stays past the
        shared region, which is what makes COW unreachable on the
        standard path (DESIGN.md §12).  Hit entries are touched MRU."""
        with tracing.span("prefix.match"):
            prompt = np.asarray(prompt).reshape(-1)
            ps = self.pool.page_size
            out: List[int] = []
            keys: List[int] = []
            key: Optional[int] = None
            for i in range((len(prompt) - 1) // ps):
                key = self._chain_key(key, prompt[i * ps:(i + 1) * ps])
                entry = self._entries.get(key)
                if entry is None:
                    break
                out.append(entry.page)
                keys.append(key)
            for k in keys:
                self._touch(k)
            return out

    def insert(self, prompt: np.ndarray, pages: Sequence[int]) -> int:
        """Register every full page-aligned block of ``prompt`` (block
        ``i`` lives in ``pages[i]`` of the request's table), taking one
        pool reference per newly indexed page.  Blocks already indexed
        (the request's own hits, or a same-content sibling) are touched
        MRU and skipped.  Returns the number of new entries."""
        with tracing.span("prefix.insert"):
            prompt = np.asarray(prompt).reshape(-1)
            ps = self.pool.page_size
            key: Optional[int] = None
            new = 0
            for i in range(len(prompt) // ps):
                parent = key
                key = self._chain_key(key, prompt[i * ps:(i + 1) * ps])
                if key in self._entries:
                    self._touch(key)
                    continue
                self._take(int(pages[i]))
                self._new_entry(key, int(pages[i]), parent)
                pe = self._entries.get(parent) if parent is not None else None
                if pe is not None:
                    pe.children += 1
                new += 1
            return new

    def evictable_pages(self, exclude: Iterable[int] = ()) -> int:
        """Pages the index could return to the pool right now: indexed
        pages nobody else holds (refcount 1) and not pinned by
        ``exclude`` (pages promised to this tick's other admissions)."""
        tracing.count("prefix.evictable_scanned", len(self._entries))
        top = self._top
        pages = np.asarray(self._page)[:top][np.asarray(self._live)[:top]]
        return int(np.count_nonzero(self._unpinned(pages, set(exclude))))

    def _unpinned(self, pages: np.ndarray, exclude: set) -> np.ndarray:
        """Which of ``pages`` only the index holds (refcount 1) and
        ``exclude`` leaves free; a page outside the pool never."""
        n = self.pool.num_pages
        ok = (pages > 0) & (pages < n)
        pinned = np.zeros(n, bool)
        pinned[[int(p) for p in exclude if 0 <= p < n]] = True
        ok[ok] = (self.pool.refcounts(pages[ok]) == 1) & ~pinned[pages[ok]]
        return ok

    def evict(self, n_pages: int, exclude: Iterable[int] = ()) -> int:
        """Drop LRU leaf entries until ``n_pages`` pages returned to the
        free list (or nothing evictable remains).  Returns pages freed."""
        with tracing.span("prefix.evict"):
            return self._evict(n_pages, exclude)

    def _evict(self, n_pages: int, exclude: Iterable[int]) -> int:
        # Victims in LRU order: the evictable leaves as they stand, sorted
        # by stamp once, merged with the parents the evictions leave one
        # child fewer.  Each is checked again when its turn comes, so this
        # picks what a scan from the LRU end would.  (A victim holds its
        # page's only reference, so its release turns no other row's page
        # evictable.)
        n = self.pool.num_pages
        exs = {int(p) for p in exclude}
        top, stamp = self._top, np.asarray(self._stamp)
        rows = np.flatnonzero(np.asarray(self._live)[:top]
                              & (np.asarray(self._children)[:top] == 0))
        rows = rows[self._unpinned(np.asarray(self._page)[rows], exs)]
        rows = rows[np.argsort(stamp[rows])]
        order = list(zip(stamp[rows].tolist(), rows.tolist()))
        later: List = []           # (stamp, row): turned evictable meanwhile
        page_of, live, children = self._page, self._live, self._children
        i = freed = 0
        while freed < n_pages:
            if later and (i == len(order) or later[0] < order[i]):
                row = heapq.heappop(later)[1]
            elif i < len(order):
                row = order[i][1]
                i += 1
            else:
                break
            page = page_of[row]
            if not (live[row] and children[row] == 0 and 0 < page < n
                    and self.pool.refcount(page) == 1 and page not in exs):
                continue
            parent = self._remove(self._key[row])
            freed += 1
            if parent is not None:
                heapq.heappush(later, (self._stamp[parent.row], parent.row))
        self.evictions += freed
        return freed

    # -- reference ledger (fault-tolerant accounting) ----------------------

    def _take(self, page: int) -> None:
        self.pool.share([page])
        if not self._owned_n[page]:
            self._takes += 1
            self._owned_at[page] = self._takes
        self._owned_n[page] += 1

    def _release(self, page: int) -> None:
        """Release one index reference *if the ledger holds one* — the
        ledger, not the (possibly corrupted) entry field, decides what
        may be freed, so a scrambled entry can never double-free."""
        if 0 <= page < len(self._owned_n) and self._owned_n[page] > 0:
            self._owned_n[page] -= 1
            self.pool.free([page])

    def verify(self) -> List[str]:
        """Self-check: cross-validate the lookup entries against the
        reference ledger and the pool.  Returns a list of inconsistency
        descriptions (empty == healthy).  Checked invariants:

        * every entry's page is a valid, non-null, live (refcount >= 1)
          pool page,
        * the multiset of entry pages equals the ledger exactly (one
          entry per owned reference — no orphan refs, no unref'd entry),
        * every non-root parent link resolves to an existing entry,
        * stored ``children`` counts match the actual link structure.

        Every entry is checked on every call, by :meth:`_consistent`'s
        array passes; only when they find a fault does the per-entry
        :meth:`_verify` run, to word the report (counted as
        ``prefix.verify_worded``).

        The engine runs this each step; on any report it drops the whole
        cache via :meth:`clear` (ledger-exact, so no page leaks) and
        keeps serving uncached rather than mapping poisoned pages into
        new tables."""
        tracing.count("prefix.entries_verified", len(self._entries))
        with tracing.span("prefix.verify"):
            healthy = self._consistent()
            tracing.count("prefix.verify_worded", int(not healthy))
            return [] if healthy else self._verify()

    def _consistent(self) -> bool:
        """:meth:`verify`'s invariants over every live row at once."""
        rows = np.flatnonzero(np.asarray(self._live)[:self._top])
        if rows.size != len(self._entries):
            return False
        n = self.pool.num_pages
        pages = np.asarray(self._page)[rows]
        if rows.size and (pages.min() < 1 or pages.max() >= n):
            return False                          # an invalid or null page
        if not (self.pool.refcounts(pages) >= 1).all():
            return False                          # an unreferenced page
        if not np.array_equal(np.bincount(pages, minlength=n),
                              np.asarray(self._owned_n)):
            return False                          # pages != the ledger
        children = np.asarray(self._children)[rows]
        parents = np.asarray(self._parent)[rows[~np.asarray(self._root)[rows]]]
        if children.min(initial=0) < 0 or children.sum() != parents.size:
            return False                          # counts != the links
        # every key repeated as often as it counts children: the parent
        # keys exactly, as multisets, iff no link dangles and every
        # children count is right
        keys = np.asarray(self._key)[rows]
        return np.array_equal(np.sort(np.repeat(keys, children)),
                              np.sort(parents))

    def _verify(self) -> List[str]:
        issues: List[str] = []
        counts: Dict[int, int] = {}
        actual_children: Dict[int, int] = {}
        for e in self._entries.values():
            if e.parent is not None:
                actual_children[e.parent] = \
                    actual_children.get(e.parent, 0) + 1
        for key, e in self._entries.items():
            counts[e.page] = counts.get(e.page, 0) + 1
            if not (0 < e.page < self.pool.num_pages):
                issues.append(f"entry {key}: invalid page id {e.page}")
            elif self.pool.refcount(e.page) < 1:
                issues.append(f"entry {key}: page {e.page} is unreferenced")
            if e.parent is not None and e.parent not in self._entries:
                issues.append(f"entry {key}: dangling parent link")
            want = actual_children.get(key, 0)
            if e.children != want:
                issues.append(f"entry {key}: children count {e.children} "
                              f"!= actual {want}")
        if counts != self._owned:
            extra = {p: c for p, c in counts.items()
                     if self._owned.get(p, 0) != c}
            missing = {p: c for p, c in self._owned.items()
                       if counts.get(p, 0) != c}
            issues.append(f"entry pages diverge from owned-ref ledger "
                          f"(entries {extra} vs ledger {missing})")
        return issues

    def drop_pages(self, pages: Iterable[int]) -> int:
        """Quarantine: remove every entry whose page is in ``pages`` —
        plus all descendant entries, so chains stay contiguous from the
        root — releasing their ledger references.  Used when a request
        FAILS the non-finite guard: its pages' cached K/V is suspect and
        must never be mapped into a later table.  Returns entries
        dropped."""
        targets = {int(p) for p in pages}
        doomed = {k for k, e in self._entries.items() if e.page in targets}
        grew = True
        while grew:          # descendants of doomed entries go too
            grew = False
            for k, e in self._entries.items():
                if k not in doomed and e.parent in doomed:
                    doomed.add(k)
                    grew = True
        for k in doomed:
            self._remove(k)
        return len(doomed)

    def clear(self) -> int:
        """Release every index reference (pages still mapped by active
        requests stay alive through the requests' own refs).  Returns
        the number of entries dropped.  Frees by the *ledger*, not the
        entries, so it is safe to call on a corrupted index — exactly
        the references taken are returned, never more or less."""
        n = len(self._entries)
        for page, cnt in list(self._owned.items()):
            self.pool.free([page] * cnt)
        np.asarray(self._owned_n)[:] = 0
        self._entries.clear()
        self._top = 0                     # every row free again
        self._free_rows.clear()
        return n

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "evictions": self.evictions}
