"""Deterministic synthetic datasets, torch port of
``src/repro/data/synthetic.py``.

A batch is a pure function of (seed, step), drawn with numpy exactly as
the reference draws it, so both packages see bit-equal batches and any
process can regenerate any batch after a restart.  Batches are CPU
tensors; the caller moves them to its device.

* ``TokenTask``: an order-2 random automaton over the vocab with noise,
  structure a model can learn with no file on disk;
* ``JetsTask``: 5-class gaussian mixtures over 16 features (the paper's
  jet tagging task, synthesized);
* ``ImageTask``: low-pass class templates plus noise (SVHN and
  Fashion-MNIST stand-ins).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["TokenTask", "JetsTask", "ImageTask"]


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


@dataclasses.dataclass(frozen=True)
class JetsTask:
    """Paper benchmark: 16 features -> 5 classes (W/Z/t/q/g)."""

    features: int = 16
    classes: int = 5
    seed: int = 7
    scale: float = 0.8   # the reference's setting (~92 % baseline accuracy)

    def _centers(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.normal(size=(self.classes, self.features)) * self.scale

    def batch(self, step: int, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, 16) float32 and labels (B,) int32, CPU tensors."""
        centers = self._centers()
        rng = np.random.default_rng((self.seed, step))
        y = rng.integers(0, self.classes, size=batch)
        x = centers[y] + rng.normal(size=(batch, self.features))
        return (torch.from_numpy(x.astype(np.float32)),
                torch.from_numpy(y.astype(np.int32)))


@dataclasses.dataclass(frozen=True)
class ImageTask:
    """Template-plus-noise image classification (SVHN / F-MNIST scale),
    images NHWC."""

    height: int = 28
    width: int = 28
    channels: int = 1
    classes: int = 10
    seed: int = 11
    noise: float = 0.6

    def _templates(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        t = rng.normal(size=(self.classes, self.height, self.width, self.channels))
        # low-pass: classes differ in coarse structure, like digits
        f = np.fft.rfft2(t, axes=(1, 2))
        f[:, 6:, :, :] = 0
        f[:, :, 6:, :] = 0
        return np.fft.irfft2(f, s=(self.height, self.width), axes=(1, 2)).real * 3.0

    def batch(self, step: int, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, C) float32 and labels (B,) int32, CPU tensors."""
        tem = self._templates()
        rng = np.random.default_rng((self.seed, step))
        y = rng.integers(0, self.classes, size=batch)
        x = tem[y] + rng.normal(
            size=(batch, self.height, self.width, self.channels)) * self.noise
        return (torch.from_numpy(x.astype(np.float32)),
                torch.from_numpy(y.astype(np.int32)))
