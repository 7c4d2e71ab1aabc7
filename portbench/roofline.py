"""The yardstick's numbers: the card's peaks, and the bytes and
operations of a kernel's call or of a model's token, counted from shapes.

Peaks are NVIDIA's H100 SXM data sheet's (dense, no sparsity), at the
full 700 W power limit; a run reports the card's own limit beside them.
A call's least time is the larger of its bytes over the HBM bandwidth
and its operations over the peak of the dtype it computes in.  Bytes
count each input byte read once and each output byte written once;
where work depends on the data (a row's cache length, the live tiles of
a packed weight, the rows routed to the experts) the count is what the
call's inputs need.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {                 # dense, per second
    "bfloat16": 989e12,
    "float16": 989e12,
    "float8": 1979e12,
    "tf32": 495e12,
    "float32": 67e12,          # outside the tensor cores
}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float8": 1}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take for a call."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def paged_decode_call(cache_lens: Sequence[int], *, heads: int, kv_heads: int,
                      head_dim: int, page_size: int, act: str, pool: str):
    """(bytes, flops) of one paged-decode call over rows whose cached
    lengths are ``cache_lens``: the query and the new K/V in ``act``, each
    row's cached K and V in ``pool`` and its page-table entries, the
    lengths, and the fp32 output; scores and P.V over each row's cached
    positions plus the new one."""
    c = np.asarray(cache_lens, np.int64)
    b = c.size
    a, p = BYTES[act], BYTES[pool]
    nbytes = (b * heads * head_dim * a + 2 * b * kv_heads * head_dim * a
              + int(c.sum()) * kv_heads * head_dim * p * 2
              + int(np.sum(-(-c // page_size))) * 4 + b * 4
              + b * heads * head_dim * 4)
    flops = 4 * heads * head_dim * int(np.sum(c + 1))
    return nbytes, flops


def bsr_call(rows: int, k: int, n: int, live_tiles: int, *, tile: int,
             act: str, weight: str, extra_in: int = 0):
    """(bytes, flops) of one block-sparse product of ``rows`` rows (K
    wide) by a packed (K, N) weight with ``live_tiles`` live tiles:
    the live tiles, the rows in, the rows out, and ``extra_in`` more
    input elements (an epilogue's multiplier or residual) in ``act``."""
    a, w = BYTES[act], BYTES[weight]
    nbytes = (live_tiles * tile * tile * w + rows * k * a + rows * n * a
              + extra_in * a)
    flops = 2 * rows * live_tiles * tile * tile
    return nbytes, flops


def planes_call(rows: int, k: int, n: int, live_tiles_per_expert: int,
                experts: int, *, tile: int, act: str, weight: str,
                extra_in: int = 0):
    """(bytes, flops) of one planes call (every expert's product in one
    launch) with ``rows`` routed rows in all, each expert holding
    ``live_tiles_per_expert`` live tiles and every expert receiving a
    row."""
    a, w = BYTES[act], BYTES[weight]
    nbytes = (experts * live_tiles_per_expert * tile * tile * w
              + rows * k * a + rows * n * a + extra_in * a)
    flops = 2 * rows * live_tiles_per_expert * tile * tile
    return nbytes, flops


def model_flops(cfg: Dict, plan: Dict[str, int], live: Dict[str, float],
                tokens: int, contexts: int, *, dense_weights: int,
                other_flops: int) -> float:
    """Model FLOPs of ``tokens`` tokens that attend over ``contexts``
    positions in all (each token's own included), over the layer plan
    ``plan`` (``spec.plan_counts``): 2 per live weight of the packed
    matrices a token uses (``live``: live weights of one matrix of each
    kind; a token uses the matrix of a non-expert kind in every layer
    that holds it, and ``top-k`` experts' in every MoE layer), 2 per
    weight of the dense products (each MoE layer's router, the tied LM
    head, and the reference's ``dense_weights`` a token), the
    reference's ``other_flops`` a token, and 4 * heads * head_dim per
    attended position per attention layer."""
    from .spec import KIND_LAYER
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = cfg.get("head_dim") or d // h
    topk = cfg.get("num_experts_per_tok", 0)
    per_token = (2 * d * plan["experts"] * plan["moe"] + 2 * d * cfg["vocab_size"]
                 + 2 * dense_weights + other_flops)
    for kind, n in live.items():
        layer = KIND_LAYER[kind]
        per_token += 2 * n * plan[layer] * (topk if layer == "moe" else 1)
    return float(per_token * tokens + 4 * h * dh * plan["attn"] * contexts)


def prefill_contexts(length: int, start: int) -> int:
    """Positions attended by a prefill's ``length`` tokens at ``start``
    in all: token ``p`` attends over ``p + 1``."""
    return length * start + length * (length + 1) // 2


def share(seconds_least: float, seconds_taken: float):
    """A roofline share in %, or None where nothing was timed."""
    if not seconds_taken or seconds_taken <= 0 or not math.isfinite(seconds_taken):
        return None
    return 100.0 * seconds_least / seconds_taken


def train_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one dense training step by the usual convention: 6
    per weight of every product per token (the layers' matrices and the
    tied LM head) and 12 * heads * head_dim per attended position per
    layer (causal attention, forward and backward)."""
    d, h, f = cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"]
    dh = d // h
    kv = cfg["num_key_value_heads"] * dh
    layers, v = cfg["num_hidden_layers"], cfg["vocab_size"]
    n = layers * (2 * d * h * dh + 2 * d * kv + 3 * d * f) + v * d
    return 6.0 * n * batch * seq + 12.0 * layers * h * dh * batch * seq * (seq + 1) / 2
