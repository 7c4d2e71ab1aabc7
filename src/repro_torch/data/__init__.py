"""Deterministic synthetic data of the torch port."""
from .pipeline import LMPipeline
from .synthetic import ImageTask, JetsTask, TokenTask

__all__ = ["LMPipeline", "TokenTask", "JetsTask", "ImageTask"]
