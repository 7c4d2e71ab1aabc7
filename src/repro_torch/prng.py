"""Threefry-2x32 keys and samplers in integer torch ops — the port's
counterpart of the ``jax.random`` functions that sampling and the
serving engine use: ``PRNGKey``, ``fold_in``, ``split``, ``bits``,
``uniform``, ``gumbel`` and ``categorical`` (the Gumbel-max trick, in
``jax.random``'s default ``mode="low"``).

A key is an int64 tensor of shape ``(..., 2)`` whose two entries hold the
two uint32 words of a JAX key, so a batch of per-row keys is a ``(B, 2)``
tensor that can sit in a CUDA graph's static buffer or in a host
snapshot.  uint32 arithmetic is carried in int64 and masked back to 32
bits after every add; a rotation is a shift-and-or.  Counters follow JAX
with ``jax_threefry_partitionable`` on (the default of JAX 0.9): element
``n`` of a sample of ``shape`` hashes the counter pair ``(n >> 32, n &
0xFFFFFFFF)`` of its flat index, and a split key ``i`` is the hash of
``(0, i)``.  Keys and bits are therefore bit-identical to ``jax.random``
for the same seed; ``torch.Generator`` could not give that.

Every function takes a leading batch of keys: the sample of ``shape``
for keys ``(..., 2)`` has shape ``(...,) + shape``, each row drawn from
its own key exactly as ``jax.random`` would draw it from that key alone.
Everything stays on the keys' device and never syncs with the host.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "split", "bits", "uniform", "gumbel",
           "categorical", "threefry2x32", "to_uint32_words", "from_uint32_words"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY32 = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; int64 tensors holding uint32 values,
    broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(0, seed mod 2**32)``
    (JAX's 32-bit default mode keeps the low word of an int seed)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has shape (..., 2), got {tuple(key.shape)}")
    key = key.to(torch.int64)
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data
    mod 2**32)`` under ``key``; ``data`` an int or an integer tensor
    broadcasting against the keys' batch."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys ``(..., num, 2)``, new key
    ``i`` the hash of the counter pair ``(0, i)``."""
    k1, k2 = _words(key)
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(idx), idx)
    return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): uint32 values in an
    int64 tensor of shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(key)
    lead = k1.shape
    k1 = k1.reshape(lead + (1,) * len(shape))
    k2 = k2.reshape(lead + (1,) * len(shape))
    n = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=key.device).reshape(shape)
    b1, b2 = threefry2x32(k1, k2, n >> 32, n & M32)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), minus 1, scaled into [minval, maxval)
    and clamped below at ``minval``.  Bit-identical to JAX for the
    bounds the samplers use ([0, 1) and [tiny, 1), where the scale is
    exactly 1); for others within one float32 ulp, since XLA may fuse
    the scale and the shift into one rounding."""
    b = bits(key, shape)
    one = 0x3F800000                               # float32 1.0
    f = ((b >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference rounded to float32 on the host, as
    # JAX computes them: no scalar tensor is copied to the device
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    return torch.clamp(f * float(scale) + float(lo), min=float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, ``mode="low"``):
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY32, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax of
    ``logits + gumbel noise`` (first index on ties).  A single key (2,)
    draws noise of the whole of ``logits.shape`` as JAX does; keys
    ``(B, 2)`` draw each row ``logits[b]`` from its own key.  Returns
    int64 indices of shape ``logits.shape[:-1]``."""
    shape = logits.shape[key.dim() - 1:]
    noise = gumbel(key, shape)
    return torch.argmax(noise + logits.to(torch.float32), dim=-1)


def to_uint32_words(key: torch.Tensor) -> torch.Tensor:
    """Keys as int32 whose bits are the uint32 words (for packing into an
    int32 buffer; ``numpy.view(np.uint32)`` reads them back)."""
    k = key.to(torch.int64)
    return torch.where(k >= 2 ** 31, k - 2 ** 32, k).to(torch.int32)


def from_uint32_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_uint32_words`: int64 keys from int32 bits."""
    return words.to(torch.int64) & M32

