"""Feed-forward blocks, torch port of ``src/repro/models/ffn.py``.

The whole SwiGLU tail rides the matmul epilogues (:41-61): the gate
matmul applies ``act(gate) * up`` on its fp32 accumulator and the down
projection adds the residual, so on packed params no standalone
(B, T, d_ff) activation or pre-residual tensor is materialized.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import logical_constraint
from .layers import dense, dense_init

__all__ = ["mlp_init", "mlp_apply"]


def mlp_init(d_model: int, d_ff: int, *, generator, device, gated: bool = True,
             use_bias: bool = False, dtype=torch.float32) -> Dict:
    kw = dict(generator=generator, device=device, use_bias=use_bias, dtype=dtype)
    p = {
        "w_up": dense_init(d_model, d_ff, **kw),
        "w_down": dense_init(d_ff, d_model, **kw),
    }
    if gated:
        p["w_gate"] = dense_init(d_model, d_ff, **kw)
    return p


def mlp_apply(p: Dict, x: torch.Tensor, *, activation: str = "silu",
              accum=None, residual=None) -> torch.Tensor:
    """Gated/plain MLP; with ``residual`` the result IS the updated
    residual stream."""
    accum = accum or torch.float32
    if "w_gate" in p:
        up = logical_constraint(dense(p["w_up"], x), "batch", "seq", "mlp")
        h = dense(p["w_gate"], x, activation=activation, multiplier=up)
    else:
        h = dense(p["w_up"], x, activation=activation)
    h = logical_constraint(h, "batch", "seq", "mlp")
    out = dense(p["w_down"], h, accum=accum, residual=residual)
    return logical_constraint(out, "batch", "seq", "embed")
