"""Roofline analysis of a traced dry-run step — torch port of
``src/repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), all in seconds:

    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = bytes_per_device / HBM_bw
    collective = wire_bytes_per_device / network link bw

The reference reads XLA's per-device ``cost_analysis`` and parses the
collectives out of the compiled HLO text.  Here both come from the
per-rank counter (``distributed/cost.py``), which sees the local ops and
the collectives of one rank while the step is traced:
``collectives_from_trace`` takes the place of ``parse_collectives`` and
``analyze_trace`` that of ``analyze_compiled``.  The collectives' wire
bytes follow the reference's ring model (``_wire``):

    all-gather      out_bytes * (g-1)/g     (out = full gathered buffer)
    all-reduce      2 * bytes * (g-1)/g
    reduce-scatter  shard_bytes * (g-1)
    all-to-all      bytes * (g-1)/g
    collective-permute  bytes

The defaults price an H100 SXM (``core.resource_model.H100_SXM``); pass
``hw=TPU_V5E`` for the reference's constants.  The port traces every
trip of its Python loops, so nothing is added for loop bodies
(``launch/supplements.py``).  ``bytes_per_dev`` counts each unfused op's
operands and results, so the memory term is that of the port's eager
program, larger than XLA's fused count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.resource_model import H100_SXM, HardwareSpec

__all__ = [
    "CollectiveOp", "collectives_from_trace", "wire_bytes_per_device",
    "roofline_terms", "model_flops", "RooflineRecord", "analyze_trace",
]


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int          # per-device result buffer bytes
    group_size: int
    wire_bytes: float          # modeled per-device wire traffic


def _wire(kind: str, nbytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(nbytes) * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return float(nbytes)
    return 0.0


def collectives_from_trace(counter) -> List[CollectiveOp]:
    """The traced rank's collectives (a ``distributed.cost.CostCounter``)
    with their modeled wire bytes."""
    return [CollectiveOp(c.kind, c.result_bytes, c.group_size,
                         _wire(c.kind, c.result_bytes, c.group_size))
            for c in counter.collectives]


def wire_bytes_per_device(ops: List[CollectiveOp]) -> float:
    return float(sum(o.wire_bytes for o in ops))


def roofline_terms(
    flops_per_dev: float,
    bytes_per_dev: float,
    wire_per_dev: float,
    hw: HardwareSpec = H100_SXM,
) -> Dict[str, float]:
    return {
        "compute_s": flops_per_dev / hw.peak_flops_bf16,
        "memory_s": bytes_per_dev / hw.hbm_bw,
        "collective_s": wire_per_dev / hw.ici_bw,
    }


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Useful-model-FLOPs for the cell: 6·N·D train, 2·N·D prefill,
    2·N_active·B + KV-read flops for decode (N = active params for MoE)."""
    n_active = cfg.active_param_count()
    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        return 2.0 * n_active * tokens
    from repro_torch.models.transformer import layer_specs

    attn_layers = sum(1 for s in layer_specs(cfg) if s.mixer == "attn")
    kv_len = min(cell.seq_len, cfg.window) if cfg.window else cell.seq_len
    attn_flops = (
        4.0 * cell.global_batch * cfg.n_heads * cfg.head_dim_() * kv_len * attn_layers
    )
    return 2.0 * n_active * cell.global_batch + attn_flops


@dataclasses.dataclass
class RooflineRecord:
    arch: str
    cell: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    wire_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_ratio: float          # MODEL_FLOPS / (FLOPs * chips)
    collectives: Dict[str, int]
    memory_stats: Dict[str, float]
    supplements: Dict[str, float]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze_trace(
    counter,
    cfg: ModelConfig,
    cell: ShapeCell,
    *,
    mesh_name: str,
    chips: int,
    output_bytes: int = 0,
    supplements: Optional[Dict[str, float]] = None,
    hw: HardwareSpec = H100_SXM,
) -> RooflineRecord:
    """The record of one traced step.  ``counter``: the ``CostCounter``
    that ran over it, its ``live`` the state and inputs.  Memory:
    ``argument_gb`` the bytes of those this rank holds, ``output_gb`` the
    step's outputs,
    ``peak_gb`` the counter's peak of live bytes, ``temp_gb`` the peak
    above the arguments; ``alias_gb`` is 0 (the port's step returns new
    state next to the old, it donates nothing)."""
    from repro_torch.distributed.sharding import cost_analysis

    ca = cost_analysis(counter)
    flops = float(ca.get("flops", 0.0))
    byts = float(ca.get("bytes accessed", 0.0))
    ops = collectives_from_trace(counter)
    wire = wire_bytes_per_device(ops)

    supplements = supplements or {}
    flops += supplements.get("flops", 0.0)
    byts += supplements.get("bytes", 0.0)

    terms = roofline_terms(flops, byts, wire, hw)
    dominant = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops(cfg, cell)
    peak = float(counter.peak_bytes)
    argument_bytes = counter.baseline_bytes
    mem = {
        "argument_gb": argument_bytes / 1e9,
        "output_gb": output_bytes / 1e9,
        "temp_gb": (peak - argument_bytes) / 1e9,
        "alias_gb": 0.0,
        "peak_gb": peak / 1e9,
    }
    counts: Dict[str, int] = {}
    for o in ops:
        counts[o.kind] = counts.get(o.kind, 0) + 1
    return RooflineRecord(
        arch=cfg.name,
        cell=cell.name,
        mesh=mesh_name,
        chips=chips,
        flops_per_dev=flops,
        bytes_per_dev=byts,
        wire_per_dev=wire,
        compute_s=terms["compute_s"],
        memory_s=terms["memory_s"],
        collective_s=terms["collective_s"],
        dominant=dominant,
        model_flops_total=mf,
        useful_ratio=mf / max(flops * chips, 1e-30),
        collectives=counts,
        memory_stats=mem,
        supplements=dict(supplements),
    )
