"""Train steps and the fault-tolerant trainer of the torch port."""
from .train_step import (
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from .trainer import Trainer, TrainerConfig

__all__ = [
    "init_train_state", "make_decode_step", "make_prefill_step",
    "make_train_step", "Trainer", "TrainerConfig",
]
