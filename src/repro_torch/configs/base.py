"""Model configuration for the torch port.

Counterpart of ``src/repro/configs/base.py``: ``ModelConfig`` (:20,
with its analytic ``param_count`` / ``active_param_count``),
``make_smoke`` (:206) and the dry-run's shape cells (``ShapeCell``,
``SHAPES``, ``cell_applicable``, ``input_specs``, :144-203).  The fields,
defaults, names and values are the reference's, so a config or a cell
prints and compares the same on both sides; ``dtype`` / ``adtype`` return
torch dtypes.  ``input_specs`` returns meta-device tensors, the
counterpart of ``jax.ShapeDtypeStruct``: shapes and dtypes, nothing
allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "cell_applicable",
           "input_specs", "make_smoke", "torch_dtype"]

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

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers), the reference's
        formula (:96)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_()
        total = v * d * (1 if self.tie_embeddings else 2)
        from repro_torch.models.transformer import layer_specs  # lazy: cycle

        for spec in layer_specs(self):
            if spec.mixer == "attn":
                total += d * self.n_heads * hd * 2 + d * self.kv_heads * hd * 2
            elif spec.mixer == "mamba":
                di = 2 * d
                dtr = max(d // 16, 1)
                total += d * 2 * di + di * (dtr + 2 * self.d_state) + dtr * di + di * d
            elif spec.mixer == "mlstm":
                di = int(self.mlstm_proj_factor * d)
                total += 2 * d * di + 3 * di * di + di * d
            elif spec.mixer == "slstm":
                total += 4 * d * d + 4 * d * (d // self.n_heads) + 2 * d * int(4 / 3 * d)
            if spec.mlp == "dense":
                total += d * f * (3 if self.gated_mlp else 2)
            elif spec.mlp == "moe":
                total += self.moe_experts * d * f * (3 if self.gated_mlp else 2) + d * self.moe_experts
        if self.enc_layers:
            total += self.enc_layers * (4 * d * self.n_heads * hd + 2 * d * f)
            total += self.n_layers * 4 * d * self.n_heads * hd  # cross attn
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of experts), reference
        :128."""
        if not self.moe_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = d * f * (3 if self.gated_mlp else 2)
        from repro_torch.models.transformer import layer_specs

        moe_layers = sum(1 for s in layer_specs(self) if s.mlp == "moe")
        inactive = moe_layers * (self.moe_experts - self.moe_top_k) * per_expert
        return int(self.param_count() - inactive)


# ---------------------------------------------------------------------------
# Shape cells (reference :144-203)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k dense KV decode skipped (DESIGN.md §5)"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of the cell:

    train:   {"tokens","labels"(,"positions","patch_embeds","frames")}
    prefill: same minus labels
    decode:  {"tokens" (B,1)} + the port's ``init_caches`` on meta (in
             the activation dtype, bf16 under fp32 activations, as the
             reference) + cache_len
    """
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    batch: Dict[str, Any] = {}
    if cell.kind in ("train", "prefill"):
        batch["tokens"] = _meta((b, s), i32)
        if cell.kind == "train":
            batch["labels"] = _meta((b, s), i32)
        if cfg.mrope_sections is not None:
            batch["positions"] = _meta((b, s, 3), i32)
        if cfg.num_patches > 0:
            batch["patch_embeds"] = _meta((b, cfg.num_patches, cfg.d_model), cfg.adtype)
        if cfg.enc_layers > 0:
            batch["frames"] = _meta((b, cfg.enc_frames, cfg.d_model), cfg.adtype)
        return {"batch": batch}

    batch["tokens"] = _meta((b, 1), i32)
    from repro_torch.models.transformer import init_caches  # lazy: cycle

    dtype = cfg.adtype if cfg.activ_dtype != "float32" else torch.bfloat16
    return {
        "batch": batch,
        "caches": init_caches(cfg, b, s, dtype, device="meta"),
        "cache_len": _meta((), i32),
    }


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
