"""Optimization substrate of the torch port: masked AdamW and schedules.

Gradient compression (``optim/compression.py`` in the reference) belongs
to the multi-device work and is not ported yet.
"""
from .adamw import AdamWConfig, adamw_update, clip_by_global_norm, global_norm, init_opt_state
from .schedule import constant_lr, linear_decay, warmup_cosine

__all__ = [
    "AdamWConfig", "adamw_update", "clip_by_global_norm", "global_norm",
    "init_opt_state", "constant_lr", "linear_decay", "warmup_cosine",
]
