"""Resource-estimation function R(w) (paper §III-B, Eq. 1), torch port.

A copy of ``TPUResourceModel`` and what it needs from
``src/repro/core/resource_model.py`` (:48-159).  With the same cost
vectors the knapsack makes the same selection as the JAX package.  The
modelled resources are the reference's ``[mxu_passes, hbm_pages]``.
``H100_SXM`` is an opt-in ``HardwareSpec`` for the dry-run's roofline
(``launch/roofline.py``); ``TPUResourceModel`` keeps ``TPU_V5E``, so the
knapsack's selections stay the reference's.
``fpga_dsp_bram`` gives the paper's own FPGA vector ``[DSP, BRAM36]``
for one structure, which the paper-table experiments price with.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .structures import BlockingSpec, StructureInfo

__all__ = ["TPUResourceModel", "HardwareSpec", "TPU_V5E", "H100_SXM",
           "consecutive_groups"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """The reference target's constants the cost model reads."""

    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12
    hbm_bw: float = 819e9
    ici_bw: float = 50e9
    vmem_bytes: int = 128 * 1024 * 1024
    mxu_dim: int = 128
    sublane: int = 8
    dma_page_bytes: int = 512


TPU_V5E = HardwareSpec()

# One NVIDIA H100 SXM, the three fields the roofline reads; the others are
# the TPU's and unused for it.
H100_SXM = HardwareSpec(
    name="h100-sxm",
    # dense bf16 tensor-core peak, NVIDIA H100 data sheet (SXM, 700 W)
    peak_flops_bf16=989e12,
    # HBM3, 80 GB part, NVIDIA H100 data sheet
    hbm_bw=3.35e12,
    # one 400 Gb/s network link per GPU (ConnectX-7 InfiniBand NDR), the
    # link a 16-way mesh axis crosses: it spans two 8-GPU NVLink nodes
    ici_bw=50e9,
)

_BYTES = {"fp32": 4.0, "bf16": 2.0, "fp16": 2.0, "int8": 1.0, "fp8": 1.0, "int4": 0.5}
_MXU_SCALE = {"fp32": 2.0, "bf16": 1.0, "fp16": 1.0, "int8": 0.5, "fp8": 0.5, "int4": 0.25}


def consecutive_groups(page_bytes: int, tile_bytes: float) -> int:
    """Paper Eq. 1: tiles per memory super-block."""
    if tile_bytes >= page_bytes:
        return 1
    ratio = page_bytes / tile_bytes
    if abs(ratio - round(ratio)) < 1e-9:
        return int(round(ratio))
    return int(math.ceil(2.0 * page_bytes / tile_bytes))


@dataclasses.dataclass(frozen=True)
class TPUResourceModel:
    """Vector-valued resource estimator, resources ``[mxu, hbm]``."""

    precision: str = "bf16"
    strategy: str = "stream"
    hw: HardwareSpec = TPU_V5E

    @property
    def bytes_per_weight(self) -> float:
        return _BYTES[self.precision]

    def tile_bytes(self, blocking: BlockingSpec) -> float:
        return blocking.bk * blocking.bn * self.bytes_per_weight

    def consecutive(self, blocking: BlockingSpec) -> int:
        return consecutive_groups(self.hw.dma_page_bytes * 1024, self.tile_bytes(blocking))

    def mxu_passes(self, blocking: BlockingSpec) -> float:
        lanes_k = math.ceil(blocking.bk / self.hw.sublane) * self.hw.sublane
        lanes_n = math.ceil(blocking.bn / self.hw.mxu_dim) * self.hw.mxu_dim
        passes = (lanes_k / self.hw.mxu_dim) * (lanes_n / self.hw.mxu_dim)
        return passes * _MXU_SCALE[self.precision]

    def hbm_pages(self, blocking: BlockingSpec) -> float:
        if self.strategy == "resident":
            return 0.0
        return self.tile_bytes(blocking) / (self.hw.dma_page_bytes * 1024)

    def structure_cost(self, blocking: BlockingSpec) -> np.ndarray:
        """R(w_i) for one structure of this layer: [mxu, hbm]."""
        return np.array(
            [self.mxu_passes(blocking), self.hbm_pages(blocking)], dtype=np.float64
        )

    def layer_cost(self, info: StructureInfo) -> np.ndarray:
        return self.structure_cost(info.blocking) * info.num_structures

    # -- FPGA mode: the paper's own DSP/BRAM numbers ----------------------

    @staticmethod
    def fpga_dsp_bram(precision_bits: int, rf: int,
                      strategy: str = "resource") -> Tuple[float, float]:
        """The paper's literal resource vector for one structure.

        DSP-aware structure (length RF): 1 DSP, and RF·P bits of BRAM as
        a fraction of a 36-bit x 1024 BRAM block under the Resource
        strategy (0 under Latency).  Precisions below 10 bits map the
        multiplications to LUTs, so 0 DSPs (paper footnote 3)."""
        dsp = 0.0 if precision_bits < 10 else 1.0
        if strategy == "latency":
            return dsp, 0.0
        bram_bits_per_block = 36.0 * 1024.0
        return dsp, (rf * precision_bits) / bram_bits_per_block
