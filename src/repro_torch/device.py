"""Device choice for the port's entry points.

Entry points (``init_params``, ``ServingEngine``, ``launch.serve``) run
on the card unless the caller asks for the CPU.  With no card and no
explicit CPU request they raise instead of quietly running elsewhere.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises.
    "meta" (shapes and dtypes only, nothing allocated) is accepted for the
    dry-run's stand-ins."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' (or --device cpu) to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
