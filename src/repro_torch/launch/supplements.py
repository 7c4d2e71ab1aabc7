"""Roofline supplements for loop bodies — torch port of
``src/repro/launch/supplements.py``.

XLA's cost analysis counts a while-loop body once, so the reference adds
the cost of its scanned bodies (the sLSTM time loop; the Mamba and mLSTM
chunk loops past ``CHUNK_UNROLL_LIMIT`` chunks) ``trips - 1`` more times.
The port's dry-run traces the step op by op: every trip of a Python loop
runs and is counted once already, so nothing may be added a second time.
``supplements_for`` therefore returns ``"flops"`` and ``"bytes"`` of 0
and keeps the reference's details for the record: ``*_trips`` by the
reference's formulas, and ``*_body_flops``, the FLOPs the per-rank
counter sees over one body at the reference's per-device shapes.  Cells
where the reference adds nothing (decode; no scanned loop) return ``{}``,
as there.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell

__all__ = ["supplements_for", "CHUNK_UNROLL_LIMIT"]

# the reference's unroll limit (models/mamba.py:30, models/xlstm.py:38):
# above it its chunk loops are lax.scan bodies counted once
CHUNK_UNROLL_LIMIT = 4


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _body_flops(fn, *args) -> float:
    from repro_torch.distributed.cost import CostCounter

    with CostCounter() as counter:
        fn(*args)
    return float(counter.flops)


def supplements_for(
    cfg: ModelConfig, cell: ShapeCell, *, model_size: int, dp_size: int
) -> Dict[str, float]:
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.transformer import layer_specs

    if cell.kind == "decode":
        return {}
    s = cell.seq_len
    b = max(cell.global_batch // max(dp_size, 1), 1)
    specs = layer_specs(cfg)
    n_slstm = sum(1 for sp in specs if sp.mixer == "slstm")
    n_mamba = sum(1 for sp in specs if sp.mixer == "mamba")
    n_mlstm = sum(1 for sp in specs if sp.mixer == "mlstm")
    detail: Dict[str, float] = {}

    if n_slstm:
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        state = tuple(_meta((b, d)) for _ in range(4))
        detail["slstm_body_flops"] = _body_flops(
            xlstm_mod._slstm_step, state, _meta((b, 4 * d)),
            _meta((h, dh, 4 * dh), cfg.dtype), h)
        detail["slstm_trips"] = (s - 1) * n_slstm

    chunk = min(cfg.ssm_chunk, s)
    n_chunks = -(-s // chunk)
    scanned = n_chunks > CHUNK_UNROLL_LIMIT and s % chunk == 0
    if n_mamba and scanned:
        di, n = 2 * cfg.d_model, cfg.d_state
        dtr = max(cfg.d_model // 16, 1)
        p = {"x_proj": {"kernel": _meta((di, dtr + 2 * n), cfg.dtype)},
             "dt_proj": {"kernel": _meta((dtr, di), cfg.dtype),
                         "bias": _meta((di,), cfg.dtype)}}

        def mamba_body(p, hc, xc, a):
            dt, bm, cm = mamba_mod._ssm_params(p, xc)
            return mamba_mod._ssm_chunk(hc, dt, bm, cm, xc.to(torch.float32), a)

        detail["mamba_body_flops"] = _body_flops(
            mamba_body, p, _meta((b, di, n)), _meta((b, chunk, di), cfg.dtype),
            _meta((di, n)))
        detail["mamba_trips"] = (n_chunks - 1) * n_mamba

    if n_mlstm and scanned:
        d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
        d_in -= d_in % cfg.n_heads
        h = cfg.n_heads
        dh = d_in // h
        carry = (_meta((b, h, dh, dh)), _meta((b, h, dh)), _meta((b, h)))
        qkv = _meta((b, h, chunk, dh))
        gate = _meta((b, h, chunk))
        detail["mlstm_body_flops"] = _body_flops(
            xlstm_mod._mlstm_chunk, carry, qkv, qkv, qkv, gate, gate)
        detail["mlstm_trips"] = (n_chunks - 1) * n_mlstm

    if not detail:
        return {}
    return {"flops": 0.0, "bytes": 0.0, **detail}
