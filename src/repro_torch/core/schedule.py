"""Sparsity schedules f(s) for the iterative pruning loop (paper Alg. 2),
a copy of ``src/repro/core/schedule.py`` (numpy on the host).

The paper increments sparsity by a constant step; the cubic schedule of
Zhu & Gupta is the other common choice.  Both are vectors over the
modelled resources, the paper's ``s_T`` in R^m_+.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

__all__ = ["SparsitySchedule", "constant_step", "cubic"]

ScheduleFn = Callable[[np.ndarray, int], np.ndarray]


@dataclasses.dataclass(frozen=True)
class SparsitySchedule:
    """s_{t+1} = f(s_t, t), clipped to the target."""

    target: np.ndarray  # (m,)
    fn: ScheduleFn

    def __call__(self, s: np.ndarray, t: int) -> np.ndarray:
        s = np.asarray(s, dtype=np.float64)
        nxt = self.fn(s, t)
        return np.minimum(nxt, self.target)

    def reached(self, s: np.ndarray) -> bool:
        return bool(np.all(s >= self.target - 1e-12))


def constant_step(target: Sequence[float], step: float = 0.05) -> SparsitySchedule:
    target = np.asarray(target, dtype=np.float64)

    def fn(s, t):
        return s + step

    return SparsitySchedule(target=target, fn=fn)


def cubic(target: Sequence[float], total_iters: int) -> SparsitySchedule:
    """Zhu-Gupta: s_t = s_T * (1 - (1 - t/T)^3)."""
    target = np.asarray(target, dtype=np.float64)

    def fn(s, t):
        frac = min((t + 1) / max(total_iters, 1), 1.0)
        return target * (1.0 - (1.0 - frac) ** 3)

    return SparsitySchedule(target=target, fn=fn)
