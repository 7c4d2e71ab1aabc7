"""Train steps, the graphed train step and the fault-tolerant trainer of
the torch port."""
from .graphs import GraphedTrainStep, train_step_for
from .train_step import (
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_body,
    make_train_step,
)
from .trainer import Trainer, TrainerConfig

__all__ = [
    "init_train_state", "make_decode_step", "make_prefill_step",
    "make_train_body", "make_train_step", "GraphedTrainStep", "train_step_for",
    "Trainer", "TrainerConfig",
]
