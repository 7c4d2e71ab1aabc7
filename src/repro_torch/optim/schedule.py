"""Learning-rate schedules, torch port of ``src/repro/optim/schedule.py``.

Each schedule is a plain function of the step counter, an int or an
integer tensor, and returns an fp32 tensor on the step's device (the CPU
for an int), so a train step that keeps its counter on the card never
reads it back to the host.  The arithmetic is the reference's, in fp32.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["warmup_cosine", "constant_lr", "linear_decay", "Schedule"]

Schedule = Callable[[object], torch.Tensor]


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_lr(lr: float) -> Schedule:
    def fn(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    def fn(step):
        step = _step_f32(step)
        warm = peak * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = final_frac * peak + (1 - final_frac) * peak * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def linear_decay(peak: float, total_steps: int) -> Schedule:
    def fn(step):
        t = torch.clamp(_step_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return peak * (1.0 - t)

    return fn
