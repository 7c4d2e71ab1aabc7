"""The one traffic generator: requests from a traffic file's parameters
and ``--seed``.

Every seed gets the same multiset of sizes and arrival gaps, in another
order: lengths are the stratified quantiles ``(j + 0.5) / n`` of their
distribution (prompt tails on a fixed grid of quantiles), Poisson gaps
the stratified quantiles of the exponential, and the shared-prefix and
greedy shares exact counts.  The seed permutes them and draws the token
ids.  So two seeds differ in content and order, not in work.

Parameters read (``traffic/<mix>.json``):

* ``arrivals``: ``{"kind": "poisson", "rate_per_s": r, "lead_in_s": l}``
  (open loop, ``round(r * (l + seconds))`` requests over a lead-in of
  ``l`` seconds, which loads the engine before the window opens, and the
  window) or ``{"kind": "backlog", "requests": n, "lead_in_retired": m}``
  (all due at once; the window opens once ``m`` of them have finished);
* ``prompt``: the unshared part of a prompt, a lognormal ``median``,
  ``sigma``, clipped to ``[min, max]``, on a ``grid`` of that many
  quantiles;
* ``output``: the tokens to generate, a clipped lognormal;
* ``shared_prefix`` (optional): ``length`` tokens, one prefix per entry
  of ``popularity`` (the share of requests that start with it);
* ``greedy_share``: the share of requests decoded greedily; the others
  sample with ``sampling``;
* ``block`` (optional): prompt and output lengths, and the Poisson
  gaps, are stratified over every ``block`` consecutive requests
  (:func:`blocked`), not only over the whole stream: every seed offers
  the same load in every stretch of ``block`` requests;
* ``iid`` (optional, default false): lengths and Poisson gaps drawn
  independently from the seed instead (plain Poisson arrivals, sizes
  that can cluster), for comparing what the stratification smooths.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["stream", "lognormal_grid", "stratified", "variants", "subseed",
           "lead_in_s"]


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` derived from the run's seed (any
    non-negative int, also past 32 bits)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32,
             *(ord(c) for c in purpose)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               & np.uint64(2**63 - 1))


def _lognormal_quantile(u: np.ndarray, median: float, sigma: float) -> np.ndarray:
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf(float(x)) for x in np.ravel(u)])
    return median * np.exp(sigma * z).reshape(np.shape(u))


def stratified(n: int) -> np.ndarray:
    """The ``n`` stratified quantile levels ``(j + 0.5) / n``."""
    return (np.arange(n) + 0.5) / n


def lognormal_grid(p: Dict) -> np.ndarray:
    """The ``grid`` lengths a prompt may take: the clipped lognormal's
    quantiles at the grid's stratified levels, as ints."""
    q = _lognormal_quantile(stratified(int(p["grid"])), p["median"], p["sigma"])
    return np.clip(np.rint(q), p["min"], p["max"]).astype(np.int64)


def _lognormal_lengths(p: Dict, n: int) -> np.ndarray:
    """``n`` lengths: on the grid when ``p`` has one (each grid point
    ``n / grid`` times), else the stratified quantiles themselves."""
    if "grid" in p:
        grid = lognormal_grid(p)
        return grid[np.floor(stratified(n) * len(grid)).astype(np.int64)]
    q = _lognormal_quantile(stratified(n), p["median"], p["sigma"])
    return np.clip(np.rint(q), p["min"], p["max"]).astype(np.int64)


def _iid_lengths(p: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths drawn independently: a uniform grid point when ``p``
    has a grid, else the clipped lognormal at uniform levels."""
    if "grid" in p:
        return lognormal_grid(p)[rng.integers(0, int(p["grid"]), size=n)]
    u = np.clip(rng.random(n), 1e-12, 1.0 - 1e-12)
    q = _lognormal_quantile(u, p["median"], p["sigma"])
    return np.clip(np.rint(q), p["min"], p["max"]).astype(np.int64)


def blocked(values: np.ndarray, block: int, rng: np.random.Generator) -> np.ndarray:
    """``values`` (sorted by quantile level) in a seeded order in which
    every run of ``block`` consecutive items holds one item of each of
    ``block`` equal strata of the sorted values (the last run what is
    left), shuffled inside the run: each stretch of the stream has the
    same mix, and seeds differ in which item and in what order."""
    n = len(values)
    block = max(1, min(block, n))
    strata = np.array_split(np.arange(n), block)
    picks = [rng.permutation(s) for s in strata]
    out = []
    for j in range(-(-n // block)):
        run = [p[j] for p in picks if j < len(p)]
        out.extend(rng.permutation(run))
    return np.asarray(values)[np.asarray(out, np.int64)]


def _exact_counts(shares: Sequence[float], n: int) -> np.ndarray:
    """Integer counts summing to ``n``, nearest to ``shares * n``
    (largest remainders)."""
    raw = np.asarray(shares, np.float64) * n
    counts = np.floor(raw).astype(np.int64)
    for i in np.argsort(-(raw - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return counts


def lead_in_s(traffic: Dict) -> float:
    """Seconds of an open-loop schedule sent before the window opens."""
    return float(traffic["arrivals"].get("lead_in_s", 0.0))


def request_count(traffic: Dict, seconds: float) -> int:
    arr = traffic["arrivals"]
    if arr["kind"] == "poisson":
        return max(1, int(round(arr["rate_per_s"] * (lead_in_s(traffic) + seconds))))
    if arr["kind"] == "backlog":
        return int(arr["requests"])
    raise ValueError(f"unknown arrivals kind {arr['kind']!r}")


def stream(traffic: Dict, vocab: int, seed: int, seconds: float) -> List[Dict]:
    """The run's requests in send order: each a dict with ``t`` (send
    offset from the schedule's start, s: the window opens at
    :func:`lead_in_s`), ``prompt`` (int32 token ids), ``max_new``,
    ``greedy``, ``prefix`` (index of its shared prefix or -1) and
    ``tail`` (length of its unshared part)."""
    n = request_count(traffic, seconds)
    rng = np.random.default_rng(subseed(seed, "traffic"))
    block = int(traffic.get("block", n))
    iid = bool(traffic.get("iid", False))
    tails = _iid_lengths(traffic["prompt"], n, rng) if iid else \
        blocked(_lognormal_lengths(traffic["prompt"], n), block, rng)
    outs = _iid_lengths(traffic["output"], n, rng) if iid else \
        blocked(_lognormal_lengths(traffic["output"], n), block, rng)
    greedy = np.zeros(n, bool)
    greedy[: int(round(traffic.get("greedy_share", 1.0) * n))] = True
    greedy = rng.permutation(greedy)
    arr = traffic["arrivals"]
    if arr["kind"] == "poisson":
        span = lead_in_s(traffic) + seconds
        levels = rng.random(n) if iid else stratified(n)
        gaps = -np.log1p(-levels) / arr["rate_per_s"]
        t = np.cumsum(gaps if iid else blocked(gaps, block, rng))
        t *= min(1.0, span * (1.0 - 0.5 / n) / t[-1])  # last send inside
    else:
        t = np.zeros(n)
    sp = traffic.get("shared_prefix")
    if sp:
        owner = rng.permutation(np.repeat(
            np.arange(len(sp["popularity"])),
            _exact_counts(sp["popularity"], n)))
        prefixes = rng.integers(0, vocab, size=(len(sp["popularity"]),
                                               int(sp["length"])))
    else:
        owner = np.full(n, -1)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, vocab, size=int(tails[i]))
        prompt = tail if owner[i] < 0 else np.concatenate([prefixes[owner[i]], tail])
        reqs.append(dict(t=float(t[i]), prompt=prompt.astype(np.int32),
                         max_new=int(outs[i]), greedy=bool(greedy[i]),
                         prefix=int(owner[i]), tail=int(tails[i])))
    return reqs


def variants(traffic: Dict, page_size: int) -> List[Tuple[int, int]]:
    """Every admission prefill ``(L, start)`` the mix can reach: a cold
    prompt at start 0, and with a shared prefix (a whole number of
    pages) its tail behind a prefix hit."""
    grid = sorted(set(int(x) for x in lognormal_grid(traffic["prompt"])))
    sp = traffic.get("shared_prefix")
    if not sp:
        return [(g, 0) for g in grid]
    plen = int(sp["length"])
    if plen % page_size:
        raise ValueError(f"shared prefix {plen} is not a whole number of "
                         f"{page_size}-token pages")
    return [(plen + g, 0) for g in grid] + [(g, plen) for g in grid]
