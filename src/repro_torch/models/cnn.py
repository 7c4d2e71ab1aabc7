"""The paper's own benchmark models (Table I), torch port of
``src/repro/models/cnn.py``:

* Jets  — 4-layer FC (16 -> 64 -> 32 -> 32 -> 5), ReLU     [Duarte et al.]
* SVHN  — low-latency CNN (3 conv + 3 FC)                  [Aarrestad et al.]
* LeNet — LeNet-like with 3x3 kernels for 28x28 F-MNIST    [paper §IV-D]

Params keep the reference's layout, so structures, masks and the bridge
line up leaf for leaf: dense kernels are (in, out), conv kernels HWIO
(kh, kw, cin, cout), activations NHWC.  ``conv2d`` and ``maxpool``
permute to PyTorch's NCHW / OIHW around ``F.conv2d`` / ``F.max_pool2d``
and back; the flatten before ``fc_1`` is therefore in (H, W, C) order,
as in the reference.  Dense layers go through ``layers.dense``, so a
packed ``BSRWeight`` kernel runs the BSR kernel (§III-C codegen) with
the bias fused.  Per-layer RF and strategy live in ``FpgaLayerCfg``
(paper Table IV).

Init takes a ``torch.Generator`` and a device, like ``dense_init``; it
draws other numbers than the reference's ``jax.random`` for the same
seed, so parity tests carry the reference's params across with
``repro_torch.bridge``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from .layers import dense, dense_init, truncated_normal

__all__ = [
    "FpgaLayerCfg", "JETS_DIMS", "PAPER_MODELS", "init_jets_mlp",
    "jets_mlp_forward", "conv_init", "conv2d", "maxpool", "init_svhn_cnn",
    "svhn_cnn_forward", "init_lenet", "lenet_forward", "paper_model",
    "LENET_LAYER_CFG",
]


@dataclasses.dataclass(frozen=True)
class FpgaLayerCfg:
    """Per-layer hls4ml hardware configuration (paper Table IV)."""

    name: str
    rf: int
    strategy: str            # "latency" | "resource"
    precision_bits: int = 16


# ---------------------------------------------------------------------------
# Jets MLP (paper: 4,389 params, 76.6% acc)
# ---------------------------------------------------------------------------

JETS_DIMS = (16, 64, 32, 32, 5)


def init_jets_mlp(*, generator: torch.Generator, device,
                  dtype=torch.float32) -> Dict:
    return {
        f"fc_{i+1}": dense_init(JETS_DIMS[i], JETS_DIMS[i + 1], use_bias=True,
                                dtype=dtype, generator=generator, device=device)
        for i in range(len(JETS_DIMS) - 1)
    }


def jets_mlp_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    n = len(JETS_DIMS) - 1
    for i in range(n):
        x = dense(params[f"fc_{i+1}"], x)
        if i < n - 1:
            x = F.relu(x)
    return x  # logits (B, 5)


# ---------------------------------------------------------------------------
# Conv helpers (NHWC activations, HWIO kernels)
# ---------------------------------------------------------------------------

def conv_init(kh: int, kw: int, cin: int, cout: int, *,
              generator: torch.Generator, device,
              dtype=torch.float32) -> Dict:
    std = 1.0 / (kh * kw * cin) ** 0.5
    return {
        "kernel": truncated_normal((kh, kw, cin, cout), std, dtype,
                                   generator=generator, device=device),
        "bias": torch.zeros((cout,), dtype=dtype, device=device),
    }


def conv2d(p: Dict, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin) * kernel (kh, kw, Cin, Cout) + bias with VALID
    padding (the only one the models use), in fp32, returned in x's
    dtype and NHWC."""
    y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                 p["kernel"].to(torch.float32).permute(3, 2, 0, 1),
                 stride=stride)
    y = y.permute(0, 2, 3, 1) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def maxpool(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """Max over (size x size) windows at stride ``size``, VALID (odd
    edges dropped: 13 -> 6), NHWC in and out."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), size, size).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# SVHN CNN (Aarrestad et al.: conv 16,16,24 + dense 42,64,10; ~14k params)
# ---------------------------------------------------------------------------

def init_svhn_cnn(*, generator: torch.Generator, device,
                  dtype=torch.float32) -> Dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "conv2d_1": conv_init(3, 3, 3, 16, **kw),
        "conv2d_2": conv_init(3, 3, 16, 16, **kw),
        "conv2d_3": conv_init(3, 3, 16, 24, **kw),
        "fc_1": dense_init(24 * 2 * 2, 42, use_bias=True, **kw),
        "fc_2": dense_init(42, 64, use_bias=True, **kw),
        "fc_3": dense_init(64, 10, use_bias=True, **kw),
    }


def svhn_cnn_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 32, 32, 3) -> logits (B, 10)."""
    x = maxpool(F.relu(conv2d(params["conv2d_1"], x)))   # 30->15
    x = maxpool(F.relu(conv2d(params["conv2d_2"], x)))   # 13->6
    x = maxpool(F.relu(conv2d(params["conv2d_3"], x)))   # 4->2
    x = x.reshape(x.shape[0], -1)                        # (H, W, C) order
    x = F.relu(dense(params["fc_1"], x))
    x = F.relu(dense(params["fc_2"], x))
    return dense(params["fc_3"], x)


# ---------------------------------------------------------------------------
# LeNet-like for Fashion-MNIST (paper §IV-D: 60,074 params; 3x3 kernels)
# ---------------------------------------------------------------------------

def init_lenet(*, generator: torch.Generator, device,
               dtype=torch.float32) -> Dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "conv2d_1": conv_init(3, 3, 1, 6, **kw),        # 60 params
        "conv2d_2": conv_init(3, 3, 6, 16, **kw),       # 880 params
        "fc_1": dense_init(16 * 5 * 5, 120, use_bias=True, **kw),
        "fc_2": dense_init(120, 84, use_bias=True, **kw),
        "fc_3": dense_init(84, 10, use_bias=True, **kw),
    }


def lenet_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 28, 28, 1) -> logits (B, 10)."""
    x = maxpool(F.relu(conv2d(params["conv2d_1"], x)))    # 26 -> 13
    x = maxpool(F.relu(conv2d(params["conv2d_2"], x)))    # 11 -> 5
    x = x.reshape(x.shape[0], -1)                         # (H, W, C) order
    x = F.relu(dense(params["fc_1"], x))
    x = F.relu(dense(params["fc_2"], x))
    return dense(params["fc_3"], x)


# Paper Table IV: heterogeneous per-layer hardware configuration for LeNet.
LENET_LAYER_CFG: List[FpgaLayerCfg] = [
    FpgaLayerCfg("conv2d_1", rf=1, strategy="latency", precision_bits=18),
    FpgaLayerCfg("conv2d_2", rf=1, strategy="latency", precision_bits=18),
    FpgaLayerCfg("fc_1", rf=25, strategy="resource", precision_bits=18),
    FpgaLayerCfg("fc_2", rf=12, strategy="resource", precision_bits=18),
    FpgaLayerCfg("fc_3", rf=1, strategy="latency", precision_bits=18),
]


PAPER_MODELS = {
    "jets-mlp": (init_jets_mlp, jets_mlp_forward, (16,)),
    "svhn-cnn": (init_svhn_cnn, svhn_cnn_forward, (32, 32, 3)),
    "lenet-fmnist": (init_lenet, lenet_forward, (28, 28, 1)),
}


def paper_model(name: str):
    """(init, forward, input shape without the batch) of a paper model."""
    if name not in PAPER_MODELS:
        raise KeyError(f"unknown paper model {name!r}: {sorted(PAPER_MODELS)}")
    return PAPER_MODELS[name]
