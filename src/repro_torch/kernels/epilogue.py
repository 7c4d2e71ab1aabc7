"""Epilogue spec for the fused BSR matmul, torch port.

Counterpart of ``src/repro/kernels/epilogue.py``.  Every path (the CUDA
kernel, the plain version, the dense matmul) applies the same fp32 op
order on the accumulator (``apply_epilogue``, reference :80):

    y = accum                      # fp32
    y = y + bias                   # (N,) broadcast
    y = act(y)                     # activation, named as in jax.nn
    y = y * multiplier             # SwiGLU: y is the gate, mult the up
    y = y + residual               # skip connection

Activation names are ``jax.nn``'s.  ``jax.nn.gelu`` defaults to the tanh
approximation while ``torch.nn.functional.gelu`` defaults to the exact
erf form, so ``"gelu"`` maps to ``gelu(approximate="tanh")``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

__all__ = ["Epilogue", "apply_epilogue", "make_epilogue", "ACTIVATIONS"]

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda y: F.gelu(y, approximate="tanh"),   # jax.nn.gelu default
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
}


@dataclasses.dataclass
class Epilogue:
    """Fused matmul tail: ``act(y + bias) * multiplier + residual``."""

    bias: Optional[torch.Tensor] = None          # (N,)
    multiplier: Optional[torch.Tensor] = None    # (..., N) — SwiGLU "up"
    residual: Optional[torch.Tensor] = None      # (..., N) skip input
    activation: Optional[str] = None             # jax.nn name

    def __post_init__(self):
        if self.activation is not None and self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}; "
                             f"choose from {sorted(ACTIVATIONS)}")

    def map_operands(self, fn) -> "Epilogue":
        """New spec with ``fn`` applied to the (M, N)-shaped operands."""
        return Epilogue(
            bias=self.bias,
            multiplier=None if self.multiplier is None else fn(self.multiplier),
            residual=None if self.residual is None else fn(self.residual),
            activation=self.activation,
        )


def make_epilogue(bias=None, activation: Optional[str] = None,
                  multiplier=None, residual=None) -> Optional[Epilogue]:
    """Epilogue, or None when there is nothing to fuse."""
    if bias is None and activation is None and multiplier is None \
            and residual is None:
        return None
    return Epilogue(bias=bias, multiplier=multiplier, residual=residual,
                    activation=activation)


def apply_epilogue(y: torch.Tensor, epi: Optional[Epilogue]) -> torch.Tensor:
    """The epilogue on a plain tensor, same op order as the kernel."""
    if epi is None:
        return y
    if epi.bias is not None:
        y = y + epi.bias.to(y.dtype)
    if epi.activation is not None:
        y = ACTIVATIONS[epi.activation](y)
    if epi.multiplier is not None:
        y = y * epi.multiplier
    if epi.residual is not None:
        y = y + epi.residual
    return y
