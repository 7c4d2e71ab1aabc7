#!/usr/bin/env python3
"""Host time of the port's prefix-index scans at the sizes the serving
cells reach::

    PYTHONPATH=src python3 scripts/time_prefix_index.py [--entries 16048 17744 29801]

For each size and each of two shapes it builds an index of prompts of
48 unique 8-token blocks, as the serving engine leaves it: ``chat``
puts each behind one of four shared 64-block heads (drawn 50/25/15/10 %,
so the heads are hit and stay recently used), ``backlog`` shares
nothing.  The last 64 prompts are still mapped by a request (a chat
engine's slots: the oldest entries are the first to go).  It
prints the median over ``--calls`` calls of ``verify()``, of
``evictable_pages()`` with the heads' pages excluded, and of ``evict()``
of 48 pages (a chat prompt's median), in ms.  It runs on the CPU alone
and reads only ``repro_torch.serving``'s public surface, so the same
script times any version of the index.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from repro_torch.serving import PagePool, PrefixIndex

PAGE_SIZE = 8
HEAD_BLOCKS = 64
TAIL_BLOCKS = 48
POPULARITY = (0.5, 0.25, 0.15, 0.1)
SLOTS = 64


def build(entries: int, shared: bool, seed: int):
    """An index of about ``entries`` entries, and the heads' pages."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, 50_000, size=(len(POPULARITY),
                                          HEAD_BLOCKS * PAGE_SIZE))
    prompts = -(-entries // TAIL_BLOCKS)
    pool = PagePool(num_pages=prompts * (TAIL_BLOCKS + 1)
                    + heads.size // PAGE_SIZE + 1, page_size=PAGE_SIZE)
    idx = PrefixIndex(pool)
    for i in range(prompts):
        tail = rng.integers(0, 50_000, size=TAIL_BLOCKS * PAGE_SIZE + 1)
        head = heads[rng.choice(len(POPULARITY), p=POPULARITY)]
        prompt = (np.concatenate([head, tail]) if shared else tail
                  ).astype(np.int32)
        hits = idx.match(prompt)
        pool.share(hits)
        pages = hits + pool.alloc_pages(pool.pages_for(len(prompt)) - len(hits))
        idx.insert(prompt, pages)
        if i < prompts - SLOTS:           # finished: only the index holds
            pool.free(pages)
    head_pages = {p for h in heads for p in idx.match(np.append(h, 0))}
    return pool, idx, head_pages


def median_ms(fn, calls: int) -> float:
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entries", type=int, nargs="+",
                    default=[16048, 17744, 29801])
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for n in args.entries:
        for shape in ("chat", "backlog"):
            pool, idx, heads = build(n, shape == "chat", args.seed)
            held = len(idx)
            assert idx.verify() == []
            verify = median_ms(idx.verify, args.calls)
            scan = median_ms(lambda: idx.evictable_pages(heads), args.calls)
            evict = median_ms(lambda: idx.evict(48, heads), args.calls)
            assert idx.verify() == []
            print(f"{shape} {held} entries: verify {verify:.3f} ms, "
                  f"evictable_pages {scan:.3f} ms, evict(48) {evict:.3f} ms "
                  f"({held - len(idx)} evicted)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
