"""Optimization substrate of the torch port: masked AdamW, schedules and
the int8 error-feedback gradient all-reduce (``compression``)."""
from .adamw import (
    AdamWConfig,
    adamw_update,
    adamw_update_,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
)
from .compression import compressed_psum, compressed_psum_tree, init_error_buffers
from .schedule import constant_lr, linear_decay, warmup_cosine

__all__ = [
    "AdamWConfig", "adamw_update", "adamw_update_", "clip_by_global_norm", "global_norm",
    "init_opt_state", "constant_lr", "linear_decay", "warmup_cosine",
    "compressed_psum", "compressed_psum_tree", "init_error_buffers",
]
