"""Config registry of the torch port: the reference's ten archs
(``src/repro/configs/__init__.py``), field for field.
"""
from __future__ import annotations

from typing import Dict, List

from .base import (SHAPES, ModelConfig, ShapeCell, cell_applicable, input_specs,
                   make_smoke, torch_dtype)
from .command_r_plus_104b import CONFIG as command_r_plus_104b
from .deepseek_7b import CONFIG as deepseek_7b
from .deepseek_67b import CONFIG as deepseek_67b
from .granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .qwen1_5_0_5b import CONFIG as qwen1_5_0_5b
from .qwen2_vl_2b import CONFIG as qwen2_vl_2b
from .whisper_tiny import CONFIG as whisper_tiny
from .xlstm_350m import CONFIG as xlstm_350m

ARCHS: Dict[str, ModelConfig] = {
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "mixtral-8x7b": mixtral_8x7b,
    "deepseek-7b": deepseek_7b,
    "deepseek-67b": deepseek_67b,
    "command-r-plus-104b": command_r_plus_104b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "whisper-tiny": whisper_tiny,
    "xlstm-350m": xlstm_350m,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs() -> List[str]:
    return list(ARCHS)


__all__ = ["ARCHS", "get_config", "list_archs", "ModelConfig", "make_smoke",
           "torch_dtype", "ShapeCell", "SHAPES", "cell_applicable", "input_specs"]
