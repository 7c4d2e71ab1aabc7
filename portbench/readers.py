"""Arithmetic the per-layer metric readers share.  Each reader
(``metrics/<name>.py``) takes the record of a ``--trace 1`` run and
returns its number, or None where the run holds nothing to read."""
from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

from . import roofline
from .trace import kernel_seconds


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host(rec: Dict, key: str) -> Optional[float]:
    """A number of the meter's host split (ms)."""
    h = rec.get("host")
    return None if h is None else h.get(key)


def idle_share(rec: Dict) -> Optional[float]:
    """% of the traced span in which no operation ran on the device."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def prefix_hit_share(rec: Dict) -> Optional[float]:
    """% of the window's admitted prompt tokens mapped from the prefix
    cache instead of prefilled (the engine's ``prefix_stats``)."""
    p = rec["prefix"]
    if not p["prompt_tokens"]:
        return None
    return 100.0 * p["tokens_mapped"] / p["prompt_tokens"]


def serve_mfu(rec: Dict) -> Optional[float]:
    """% of the card's peak in the configuration's dtype that the
    window's model FLOPs (its admitted prefill tokens and emitted decode
    tokens) fill over the window's seconds."""
    f, cfg = rec["flops_in"], rec["cfg"]
    flops = roofline.model_flops(
        cfg, rec["plan"], rec["live"], f["decode_tokens"] + f["prefill_tokens"],
        f["decode_contexts"] + f["prefill_contexts"], **rec["per_token"])
    if not rec["window_s"] or flops <= 0:
        return None
    return 100.0 * flops / (rec["window_s"] * roofline.PEAK_FLOPS[cfg["param_dtype"]])


def paged_decode_roofline(rec: Dict) -> Optional[float]:
    """% of the paged-decode kernel's traced device time that its
    counted work needs at least (per call: cached K/V and page entries
    of every row, query, new K/V, output; fp32 arithmetic)."""
    t = rec.get("trace")
    if not t:
        return None
    secs, calls = kernel_seconds(t, "paged_decode_kernel")
    want = rec["traced"]["decode_calls"]
    if calls != want:
        _say(f"paged decode: {calls} kernels traced, {want} calls counted")
        return None
    return roofline.share(rec["traced"]["decode_least_s"], secs)


def planes_calls(rec: Dict) -> Tuple[int, float]:
    """The planes kernel's calls over the traced span, and the least
    seconds they need: at each decode tick and each admission, in every
    MoE layer, the up, gate (its multiplier read too) and down products
    over every expert's live tiles, with ``top-k`` rows per token routed
    (no drops)."""
    cfg, plan, tr = rec["cfg"], rec["plan"], rec["traced"]
    layers, e_n, k = plan["moe"], plan["experts"], cfg["num_experts_per_tok"]
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    tile = int(cfg["pruning"]["block"][0])
    act = cfg["activ_dtype"]
    live = {kind: n // (layers * e_n) for kind, n in rec["live_tiles"].items()
            if kind.startswith("experts")}
    rows_per_call = [rec["num_slots"] * k] * tr["ticks"] + \
        [length * k for length, _ in tr["admissions"]]
    least = 0.0
    for rows in rows_per_call:
        for kind, kk, nn, extra in (("experts_up", d, f, 0),
                                    ("experts_gate", d, f, rows * f),
                                    ("experts_down", f, d, 0)):
            nb, fl = roofline.planes_call(rows, kk, nn, live[kind], e_n, tile=tile,
                                          act=act, weight=cfg["param_dtype"],
                                          extra_in=extra)
            least += layers * roofline.least_seconds(nb, fl, act)
    return 3 * layers * len(rows_per_call), least


def planes_roofline(rec: Dict) -> Optional[float]:
    """% of the planes kernel's traced device time that its counted work
    needs at least (:func:`planes_calls`)."""
    t = rec.get("trace")
    if not t or not rec["plan"]["moe"]:
        return None
    secs, calls = kernel_seconds(t, "bsr_planes_kernel")
    want, least = planes_calls(rec)
    if calls != want:
        _say(f"planes: {calls} kernels traced, {want} calls counted")
        return None
    return roofline.share(least, secs)


def train_mfu(rec: Dict) -> Optional[float]:
    """% of the card's peak in the configuration's dtype that the
    window's fine-tune steps' model FLOPs (the dense model's) fill over
    the window's seconds."""
    if not rec["window_s"] or not rec["steps"]:
        return None
    job, cfg = rec["job"], rec["cfg"]
    flops = rec["steps"] * roofline.train_step_flops(cfg, job["batch"], job["seq"])
    return 100.0 * flops / (rec["window_s"] * roofline.PEAK_FLOPS[cfg["param_dtype"]])


def knapsack_s(rec: Dict) -> Optional[float]:
    """Mean seconds of the window's knapsack steps (scoring, MDKP and
    masks, the card synchronised on both sides)."""
    ks = rec.get("knapsack_s")
    return sum(ks) / len(ks) if ks else None


def train_copy_ms(rec: Dict) -> Optional[float]:
    """Device ms of device-to-device copies per traced fine-tune step."""
    t = rec.get("trace")
    if not t or not rec.get("traced_steps"):
        return None
    secs, _ = kernel_seconds(t, "Memcpy DtoD")
    return 1e3 * secs / rec["traced_steps"]
