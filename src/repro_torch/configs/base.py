"""Model configuration for the torch port.

Counterpart of ``src/repro/configs/base.py`` (``ModelConfig`` :20 and
``make_smoke`` :206).  The fields and defaults are the reference's, so a
config prints and compares the same on both sides; ``dtype`` / ``adtype``
return torch dtypes.  ``ShapeCell`` and ``input_specs`` belong to the
dry-run tooling and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "make_smoke", "torch_dtype"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; "
                         f"choose from {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "lm"              # lm | moe | vlm | hybrid | audio | ssm
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    kv_heads: int = 8
    d_ff: int = 2048
    head_dim: Optional[int] = None

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # attention
    window: Optional[int] = None            # SWA
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    mrope_sections: Optional[Tuple[int, int, int]] = None
    attn_chunk: int = 512
    logits_softcap: Optional[float] = None

    # layer patterns (cycled over n_layers)
    mixer_pattern: Optional[Tuple[str, ...]] = None
    mlp_pattern: Optional[Tuple[str, ...]] = None

    # SSM / xLSTM
    d_state: int = 16
    d_conv: int = 4
    ssm_chunk: int = 512
    mlstm_proj_factor: float = 2.0

    # encoder-decoder (whisper) / VLM stubs
    enc_layers: int = 0
    enc_frames: int = 1500
    num_patches: int = 0

    # norms / activations / embeddings
    norm_type: str = "rmsnorm"
    activation: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = True

    # numerics / memory
    param_dtype: str = "float32"
    activ_dtype: str = "float32"
    remat: str = "none"                     # none | dots | full

    # reference perf levers (kept so configs compare equal field by field)
    seq_sharded_acts: bool = False
    row_accum_dtype: str = "float32"
    moe_impl: str = "gspmd"
    paged_attn_impl: str = "fused"

    # capability flags
    sub_quadratic: bool = False
    notes: str = ""

    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.activ_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def make_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        vocab=min(cfg.vocab, 256),
        d_model=128,
        n_layers=min(cfg.n_layers, 4),
        n_heads=4,
        kv_heads=min(cfg.kv_heads, 4) if cfg.kv_heads < cfg.n_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128,
        head_dim=32,
        moe_experts=min(cfg.moe_experts, 4) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        window=min(cfg.window, 32) if cfg.window else None,
        enc_layers=min(cfg.enc_layers, 2) if cfg.enc_layers else 0,
        enc_frames=16 if cfg.enc_layers else cfg.enc_frames,
        num_patches=8 if cfg.num_patches else 0,
        mrope_sections=(4, 6, 6) if cfg.mrope_sections else None,
        attn_chunk=16,
        ssm_chunk=16,
        d_state=8,
        param_dtype="float32",
        activ_dtype="float32",
        remat="none",
    )
    kw.update(overrides)
    return cfg.replace(**kw)
