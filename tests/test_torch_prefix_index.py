"""The port's :class:`PrefixIndex` (``repro_torch.serving.pages``).

The first three tests are the port's counterparts of the reference's
``PrefixIndex`` tests in ``tests/test_page_pool_props.py``: the ledger's
trace invariants, corruption caught by ``verify()`` with ``clear()``
still exact, and ``drop_pages`` taking descendants along.  The rest hold
the port's array passes to the per-entry loop they replace on the hot
path: ``verify()``'s passes flag exactly when the loop (``_verify``,
which still words every report) finds a fault, over random traces that
each end in one random corruption, and ``evictable_pages`` counts what
the generator expression it replaced counted, and ``evict`` drops the
victims a scan from the LRU end would.
"""
import numpy as np
import pytest

from _hyp import given, settings, st
from repro_torch import tracing
from repro_torch.serving import PagePool, PrefixIndex


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_prefix_index_ledger_trace_invariants(seed):
    """Random insert/evict/drop_pages/clear traces: at every step the
    owned-refs ledger must equal the entries' page multiset, ``verify``
    must report healthy, and the pool must balance exactly against
    request refs + ledger refs (conservation under quarantine)."""
    rng = np.random.default_rng(seed)
    pool = PagePool(num_pages=24, page_size=4)
    idx = PrefixIndex(pool)
    request_pages = []              # pages live requests still map

    def check():
        assert idx.verify() == []
        entry_pages = {}
        for e in idx._entries.values():
            entry_pages[e.page] = entry_pages.get(e.page, 0) + 1
        assert entry_pages == idx._owned
        live = sum(len(ps) for ps in request_pages) + sum(idx._owned.values())
        assert pool.live_refs() == live
        held = {p for ps in request_pages for p in ps} | set(idx._owned)
        assert pool.free_pages == 23 - len(held)

    for _ in range(40):
        op = rng.choice(["insert", "retire", "evict", "drop", "clear"])
        if op == "insert" and pool.free_pages >= 3:
            prompt = rng.integers(0, 50, size=int(rng.integers(4, 13)))
            n = pool.pages_for(len(prompt))
            hits = idx.match(prompt.astype(np.int32))
            if pool.free_pages >= n - len(hits):
                pool.share(hits)
                pages = hits + pool.alloc_pages(n - len(hits))
                idx.insert(prompt.astype(np.int32), pages)
                request_pages.append(pages)
        elif op == "retire" and request_pages:
            pool.free(request_pages.pop(int(rng.integers(len(request_pages)))))
        elif op == "evict":
            idx.evict(int(rng.integers(1, 4)))
        elif op == "drop" and idx._owned:
            victims = rng.choice(sorted(idx._owned),
                                 size=min(2, len(idx._owned)), replace=False)
            idx.drop_pages(int(v) for v in victims)
        elif op == "clear":
            idx.clear()
            assert not idx._owned and not len(idx)
        check()

    for ps in request_pages:
        pool.free(ps)
    idx.clear()
    assert pool.free_pages == 23 and pool.live_refs() == 0


def test_prefix_index_verify_catches_corruption_and_clear_is_safe():
    """Scrambled entries must be DETECTED by verify() and releasable by
    clear() without a leak or double-free — the ledger, not the corrupt
    entry fields, decides what returns to the pool."""
    rng = np.random.default_rng(11)
    pool = PagePool(num_pages=20, page_size=4)
    idx = PrefixIndex(pool)
    a = rng.integers(0, 100, size=12).astype(np.int32)
    pages = pool.alloc_pages(3)
    idx.insert(a, pages)
    assert idx.verify() == []

    # corruption 1: page field scrambled to a DIFFERENT owned page
    victim = next(iter(idx._entries.values()))
    orig = victim.page
    victim.page = pages[(pages.index(orig) + 1) % 3]
    assert any("ledger" in s for s in idx.verify())
    victim.page = orig
    assert idx.verify() == []

    # corruption 2: page field scrambled to the null page
    victim.page = 0
    assert any("invalid page" in s for s in idx.verify())
    victim.page = orig

    # corruption 3: children count drifts
    victim.children += 1
    assert any("children" in s for s in idx.verify())
    victim.children -= 1

    # corruption 4: dangling parent link
    leaf = list(idx._entries.values())[-1]
    keep_parent = leaf.parent
    leaf.parent = 123456789
    assert leaf.parent == 123456789
    reports = idx.verify()
    assert any("dangling parent" in s for s in reports)
    leaf.parent = keep_parent
    assert idx.verify() == []

    # clear() under ANY of the above frees exactly the taken refs:
    victim.page = 0                       # corrupt again, then drop all
    assert idx.clear() == 3
    pool.free(pages)                      # the request's own refs
    assert pool.free_pages == 19 and pool.live_refs() == 0
    with pytest.raises(ValueError):       # and not one ref more
        pool.free([pages[0]])


def test_prefix_index_drop_pages_quarantines_descendants():
    """drop_pages must remove the targeted blocks AND every descendant
    entry (chains stay root-contiguous), while unrelated branches keep
    matching."""
    rng = np.random.default_rng(12)
    pool = PagePool(num_pages=20, page_size=4)
    idx = PrefixIndex(pool)
    a = rng.integers(0, 100, size=16).astype(np.int32)   # 4 blocks
    a_pages = pool.alloc_pages(4)
    idx.insert(a, a_pages)
    b = np.concatenate([a[:4], rng.integers(100, 200, size=8)]).astype(np.int32)
    hits = idx.match(b)
    assert hits == a_pages[:1]
    pool.share(hits)
    b_pages = hits + pool.alloc_pages(2)
    idx.insert(b, b_pages)
    assert len(idx) == 6

    # quarantine a's block 1: blocks 2/3 are its descendants and go too;
    # the shared root (block 0) and b's branch survive
    assert idx.drop_pages([a_pages[1]]) == 3
    assert idx.match(a) == a_pages[:1]
    assert idx.match(b) == b_pages[:2]      # proper-prefix cap: 2 blocks
    assert idx.verify() == []
    # dropping the shared root kills everything
    assert idx.drop_pages([a_pages[0]]) == 3
    assert len(idx) == 0 and idx.verify() == []
    pool.free(a_pages)
    pool.free(b_pages)
    assert pool.free_pages == 19 and pool.live_refs() == 0


# ---------------------------------------------------------------------------
# the array passes against the per-entry loop
# ---------------------------------------------------------------------------

PS = 4
HEADS = np.random.default_rng(7).integers(0, 50, size=(3, 12))


def _prompt(rng):
    """A prompt behind one of three shared heads, so chains branch."""
    head = HEADS[int(rng.integers(3))][:int(rng.integers(0, 13))]
    tail = rng.integers(0, 50, size=int(rng.integers(1, 9)))
    return np.concatenate([head, tail]).astype(np.int32)


def _admit(rng, pool, idx, requests):
    """A request as the engine admits it: map the hits, evict for the
    rest if the pool runs short, index its full blocks."""
    prompt = _prompt(rng)
    hits = idx.match(prompt)
    need = pool.pages_for(len(prompt)) - len(hits)
    if pool.free_pages < need:
        idx.evict(need - pool.free_pages, exclude=set(hits))
    if pool.free_pages < need:
        return
    pool.share(hits)
    pages = hits + pool.alloc_pages(need)
    idx.insert(prompt, pages)
    requests.append(pages)


def _random_trace(rng, pool, idx, requests, steps):
    """Random admit/retire/evict/drop_pages steps, the index healthy and
    both checks agreeing after each."""
    for _ in range(steps):
        op = rng.choice(["admit", "admit", "retire", "evict", "drop"])
        if op == "admit":
            _admit(rng, pool, idx, requests)
        elif op == "retire" and requests:
            pool.free(requests.pop(int(rng.integers(len(requests)))))
        elif op == "evict":
            idx.evict(int(rng.integers(1, 4)))
        elif op == "drop" and len(idx) and rng.random() < 0.3:
            idx.drop_pages([int(rng.choice(sorted(idx._owned)))])
        assert idx._consistent() and idx._verify() == []


def _corrupt(kind, rng, pool, idx, requests):
    """Apply one corruption of ``kind``; some draws leave the index
    healthy (a field set to its own value), which the checks must agree
    on too."""
    entries = list(idx._entries.items())
    victim = entries[int(rng.integers(len(entries)))][1]
    owned = sorted(idx._owned)
    if kind == "page":
        victim.page = int(rng.choice(
            [victim.page, 0, -1, pool.num_pages, pool.num_pages + 7]
            + owned))
    elif kind == "parent":
        keys = [k for k, _ in entries]
        victim.parent = rng.choice(
            [None, victim.parent, 123456789, keys[int(rng.integers(len(keys)))]])
    elif kind == "children":
        victim.children += int(rng.choice([-2, -1, 1, 3]))
    elif kind == "ledger":
        page = int(rng.choice(owned + [int(rng.integers(1, pool.num_pages))]))
        idx._owned_n[page] += int(rng.choice([-1, 1]))
    elif kind == "refcount":
        pool._ref[victim.page] = int(rng.choice([0, pool._ref[victim.page] + 1]))
    elif kind == "reused_row":
        # a parent dropped while its children stay, then its row handed to
        # a new entry: the children's links must not resolve to that entry
        parents = [k for k, e in entries if e.children > 0]
        parent = parents[int(rng.integers(len(parents)))]
        row = idx._entries[parent].row
        idx._remove(parent)
        for _ in range(100):
            if idx._live[row]:
                break
            if requests and not pool.free_pages:
                pool.free(requests.pop(0))
            _admit(rng, pool, idx, requests)
        assert idx._live[row]


CORRUPTIONS = ("page", "parent", "children", "ledger", "refcount",
               "reused_row")


@pytest.mark.parametrize("kind", CORRUPTIONS)
@pytest.mark.parametrize("seed", range(8))
def test_array_pass_flags_exactly_when_the_loop_reports(kind, seed):
    rng = np.random.default_rng([seed, CORRUPTIONS.index(kind)])
    pool = PagePool(num_pages=48, page_size=PS)
    idx = PrefixIndex(pool)
    requests = []
    _random_trace(rng, pool, idx, requests, int(rng.integers(10, 40)))
    while not any(e.children for e in idx._entries.values()):
        _admit(rng, pool, idx, requests)      # at least one chain of two
    _corrupt(kind, rng, pool, idx, requests)
    words = idx._verify()
    assert idx._consistent() == (words == [])
    assert idx.verify() == words
    if kind == "reused_row":       # the parent back in its row, or another
        assert words                # entry there: the link must not resolve


@pytest.mark.parametrize("seed", range(3))
def test_array_pass_over_grown_and_cleared_rows(seed):
    """A pool of a few hundred pages: the rows double several times, are
    cleared and filled again, and the array pass still agrees with the
    loop, before and after one last corruption."""
    rng = np.random.default_rng([seed, 99])
    pool = PagePool(num_pages=400, page_size=PS)
    idx = PrefixIndex(pool)
    requests = []
    for _ in range(2):
        while len(idx) < 300:
            _admit(rng, pool, idx, requests)
            if len(requests) > 8:
                pool.free(requests.pop(int(rng.integers(len(requests)))))
            assert idx._consistent() and idx._verify() == []
        assert len(idx._live) >= 512
        _random_trace(rng, pool, idx, requests, 30)
        assert idx.clear() > 0 and idx._consistent() and idx._top == 0
    while not any(e.children for e in idx._entries.values()):
        _admit(rng, pool, idx, requests)
    _corrupt(CORRUPTIONS[seed % len(CORRUPTIONS)], rng, pool, idx, requests)
    words = idx._verify()
    assert idx._consistent() == (words == [])
    assert idx.verify() == words


def _evict_by_scan(idx, n_pages, exclude):
    """Leaf-first LRU eviction as a scan from the LRU end for each victim,
    the loop the victim search replaced."""
    ex = set(exclude)
    freed = 0
    while freed < n_pages:
        victim = next((k for k, e in idx._entries.items()
                       if e.children == 0 and e.page not in ex
                       and idx.pool.refcount(e.page) == 1), None)
        if victim is None:
            break
        idx._remove(victim)
        idx.evictions += 1
        freed += 1
    return freed


@pytest.mark.parametrize("seed", range(8))
def test_evict_picks_what_a_scan_from_the_lru_end_picks(seed):
    """``evict`` against the per-victim scan on twin indexes (one seeded
    trace applied to each), some with a children count zeroed or a page
    shared by two entries (as a fault leaves them before the next step's
    check)."""
    twins = []
    for _ in range(2):
        pool = PagePool(num_pages=96, page_size=PS)
        twins.append((np.random.default_rng([seed, 5]), pool,
                      PrefixIndex(pool), []))
    for _ in range(6):
        calls = []
        for rng, pool, idx, requests in twins:
            _random_trace(rng, pool, idx, requests, int(rng.integers(5, 25)))
            if len(idx) > 1 and rng.random() < 0.5:
                entries = list(idx._entries.values())
                victim = entries[int(rng.integers(len(entries)))]
                if rng.random() < 0.5:
                    victim.children = 0
                else:
                    victim.page = entries[int(rng.integers(len(entries)))].page
            pages = [e.page for e in idx._entries.values()]
            ex = set(rng.choice(pages, size=min(4, len(pages)),
                                replace=False).tolist()) if pages else set()
            calls.append((int(rng.integers(1, 12)), ex))
        assert calls[0] == calls[1]
        (n, ex), (_, pool, idx, _), (_, _, scan, _) = calls[0], *twins
        assert idx.evict(n, exclude=ex) == _evict_by_scan(scan, n, ex)
        assert list(idx._entries) == list(scan._entries)
        assert pool._ref.tolist() == scan.pool._ref.tolist()
        assert pool._free == scan.pool._free
        assert dict(idx._owned) == dict(scan._owned)
        assert ([(e.page, e.parent, e.children) for e in idx._entries.values()]
                == [(e.page, e.parent, e.children)
                    for e in scan._entries.values()])
        if not idx._consistent():
            idx.clear()
            scan.clear()


def test_evict_follows_the_lru_order_of_hits():
    """A match or a repeated insert makes its entries most recently used,
    so eviction passes them over until the rest are gone."""
    pool = PagePool(num_pages=16, page_size=PS)
    idx = PrefixIndex(pool)
    prompts = [np.full(PS, t, np.int32) for t in range(5)]   # 5 root leaves
    for p in prompts:
        pages = pool.alloc_pages(1)
        idx.insert(p, pages)
        pool.free(pages)
    page = {int(p[0]): idx.match(np.append(p, 0))[0] for p in prompts}
    idx.match(np.append(prompts[1], 0))
    idx.insert(prompts[3], [page[3]])
    idx.match(np.append(prompts[0], 0))
    assert idx.evict(3) == 3
    assert [idx.match(np.append(p, 0)) for p in prompts] == [
        [page[0]], [], [], [page[3]], []]


def test_worded_counter_counts_each_flagged_call():
    rng = np.random.default_rng(3)
    pool = PagePool(num_pages=48, page_size=PS)
    idx = PrefixIndex(pool)
    _random_trace(rng, pool, idx, [], 20)
    victim = next(iter(idx._entries.values()))
    tracing.enable()
    try:
        assert idx.verify() == []
        healthy = tracing.drain()["counters"]
        victim.children += 1
        for _ in range(3):
            assert any("children" in w for w in idx.verify())
        flagged = tracing.drain()["counters"]
    finally:
        tracing.disable()
        tracing.drain()
    assert healthy == {"prefix.entries_verified": len(idx),
                       "prefix.verify_worded": 0}
    assert flagged == {"prefix.entries_verified": 3 * len(idx),
                       "prefix.verify_worded": 3}


@pytest.mark.parametrize("seed", range(6))
def test_evictable_pages_counts_what_the_entry_loop_counts(seed):
    rng = np.random.default_rng(seed)
    pool = PagePool(num_pages=64, page_size=PS)
    idx = PrefixIndex(pool)
    requests = []
    for _ in range(4):
        _random_trace(rng, pool, idx, requests, int(rng.integers(5, 30)))
        pages = [e.page for e in idx._entries.values()]
        for ex in (set(), set(rng.choice(pages, size=min(3, len(pages)),
                                         replace=False).tolist()) if pages
                   else set(), {1, 2, pool.num_pages - 1}):
            want = sum(1 for e in idx._entries.values()
                       if pool.refcount(e.page) == 1 and e.page not in ex)
            assert idx.evictable_pages(exclude=ex) == want
            assert idx.evictable_pages(exclude=iter(ex)) == want
