"""Atomic, asynchronous checkpointing of the torch port."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
