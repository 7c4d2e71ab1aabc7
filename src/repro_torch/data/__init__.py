"""Deterministic synthetic data of the torch port."""
from .pipeline import LMPipeline
from .synthetic import TokenTask

__all__ = ["LMPipeline", "TokenTask"]
