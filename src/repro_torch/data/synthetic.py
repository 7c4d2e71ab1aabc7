"""Deterministic synthetic language-model data, torch port of
``TokenTask`` in ``src/repro/data/synthetic.py``.

A batch is a pure function of (seed, step), drawn with numpy exactly as
the reference draws it, so both packages see bit-equal tokens and any
process can regenerate any batch after a restart.  The tokens come from
an order-2 random automaton over the vocab with noise: structure a model
can learn (the loss falls under training) with no file on disk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["TokenTask"]


@dataclasses.dataclass(frozen=True)
class TokenTask:
    vocab: int
    seed: int = 0
    noise: float = 0.05

    def _auto(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.vocab, size=(min(self.vocab, 4096),), dtype=np.int32)

    def batch(self, step: int, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        """tokens/labels (B, S) int32 CPU tensors; labels are next-token."""
        table = self._auto()
        m = table.shape[0]
        rng = np.random.default_rng((self.seed, step))
        x = np.empty((batch, seq + 1), dtype=np.int32)
        x[:, 0] = rng.integers(0, self.vocab, size=batch)
        cur = x[:, 0] % m
        for t in range(1, seq + 1):
            nxt = table[cur % m] % self.vocab
            flip = rng.uniform(size=batch) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab, size=batch), nxt)
            x[:, t] = nxt
            cur = (cur * 31 + nxt) % m
        return {"tokens": torch.from_numpy(np.ascontiguousarray(x[:, :-1])),
                "labels": torch.from_numpy(np.ascontiguousarray(x[:, 1:]))}
