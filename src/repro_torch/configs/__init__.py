"""Config registry of the torch port: only the archs the port can run.

The reference registers ten archs (``src/repro/configs/__init__.py``);
the port adds each one when its mixers and MLP kinds are ported.
"""
from __future__ import annotations

from typing import Dict, List

from .base import ModelConfig, make_smoke, torch_dtype
from .granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from .qwen1_5_0_5b import CONFIG as qwen1_5_0_5b
from .xlstm_350m import CONFIG as xlstm_350m

ARCHS: Dict[str, ModelConfig] = {
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "xlstm-350m": xlstm_350m,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported to torch yet; "
                       f"choose from {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs() -> List[str]:
    return list(ARCHS)


__all__ = ["ARCHS", "get_config", "list_archs", "ModelConfig", "make_smoke",
           "torch_dtype"]
