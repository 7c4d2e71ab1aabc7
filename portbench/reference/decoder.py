"""Plain PyTorch reference of the port's decoder-only language models
(dense MLP or top-k mixture of experts), and the weights the benchmark
makes for them.  It imports nothing of ``repro_torch`` or ``repro``.

* :func:`make_weights` draws every weight on the device from the seed,
  one call per kind of weight stacked over the layers, in the dtype the
  configuration serves in.  The tiles that pruning keeps are drawn at a
  larger scale than the others, exactly ``1 - sparsity`` of them in each
  prunable matrix (each expert's matrix on its own), so the selection
  has one answer and no near-ties (see ``tile_scales``).
* :func:`select_tiles` works the pruning out again from those weights:
  each prunable leaf's ``tile x tile`` L2 norms, divided by the leaf's
  largest, and the top ``floor((1 - s) * n)`` tiles over all leaves
  (what the knapsack over equal per-tile costs selects).
* :func:`forward` is the full-sequence forward in fp32 with TF32 off,
  no cache and no batching: RMSNorm, QKV (bias), half-split RoPE, causal
  GQA softmax attention, SiLU-gated MLP or the MoE (fp32 router softmax,
  top-k by a stable descending sort, gates renormalised, every routed
  token computed: no capacity), tied unembedding.
* :func:`quantized` is the control: the same weights rounded to fp8
  e4m3 with one scale per matrix.
* :func:`params_tree` lays the weights out as the port's params tree,
  which the harness hands to the port; :func:`dense_weights_per_token`
  and :func:`other_flops_per_token` give the model FLOPs' terms that the
  layer plan cannot (``roofline.model_flops``).

Departures from the published models are the port's, listed in each
configuration file under ``departures``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

__all__ = ["make_weights", "select_tiles", "masked", "quantized", "forward",
           "prunable_kinds", "params_tree", "dense_weights_per_token",
           "other_flops_per_token"]

_DT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
       "float32": torch.float32}


def _sizes(cfg: Dict) -> Dict[str, int]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = cfg.get("head_dim") or d // h
    return dict(L=cfg["num_hidden_layers"], D=d, H=h,
                KV=cfg["num_key_value_heads"], dh=dh,
                F=cfg["intermediate_size"], V=cfg["vocab_size"],
                E=cfg.get("num_local_experts", 0),
                K=cfg.get("num_experts_per_tok", 0))


def _shapes(cfg: Dict) -> Dict[str, tuple]:
    """Each weight kind's shape, stacked over the layers."""
    s = _sizes(cfg)
    L, D, H, KV, dh, F = s["L"], s["D"], s["H"], s["KV"], s["dh"], s["F"]
    out = {"wq": (L, D, H * dh), "wk": (L, D, KV * dh), "wv": (L, D, KV * dh),
           "wo": (L, H * dh, D)}
    if s["E"]:
        E = s["E"]
        out.update(experts_up=(L, E, D, F), experts_gate=(L, E, D, F),
                   experts_down=(L, E, F, D))
    else:
        out.update(w_up=(L, D, F), w_gate=(L, D, F), w_down=(L, F, D))
    return out


def prunable_kinds(cfg: Dict) -> List[str]:
    """The weight kinds serving prunes and packs (attention and MLP or
    expert matrices)."""
    return list(_shapes(cfg))


def _tile_scale(shape, tile, keep, least, scales, gen, device):
    """(..., K/tile, 1, N/tile, 1) fp32 scales: in each trailing matrix
    exactly ``keep`` of its tiles (chosen by ``gen``) at a scale drawn
    from ``scales["kept"]``, the next ``least`` tiles from
    ``scales["least"]`` and the others from ``scales["pruned"]``."""
    lead, k, n = shape[:-2], shape[-2], shape[-1]
    if k % tile or n % tile:
        raise ValueError(f"{shape} is not a whole number of {tile}-tiles")
    gk, gn = k // tile, n // tile
    m = math.prod(lead)
    rank = torch.argsort(torch.rand((m, gk * gn), generator=gen, device=device),
                         dim=1)
    n_kept = int(round(keep * gk * gn))
    u = torch.rand((m, gk * gn), generator=gen, device=device)
    lo = torch.full_like(u, scales["pruned"][0])
    hi = torch.full_like(u, scales["pruned"][1])
    for group, sel in (("kept", rank < n_kept),
                       ("least", (rank >= n_kept) & (rank < n_kept + least))):
        if group in scales:
            lo = torch.where(sel, scales[group][0], lo)
            hi = torch.where(sel, scales[group][1], hi)
    return (lo + u * (hi - lo)).reshape(*lead, gk, 1, gn, 1)


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights for ``cfg`` from ``seed``, on ``device``,
    stacked over the layers: ``embed`` (V, D), ``final_norm`` (D), and
    (L, ...) ``pre_norm``, ``post_norm``, ``wq``/``wk``/``wv``/``wo``
    (``bq``/``bk``/``bv`` with QKV bias) and the MLP's ``w_up``/
    ``w_gate``/``w_down`` or the MoE's ``router`` (fp32) and
    ``experts_up``/``experts_gate``/``experts_down``.  Matrix entries
    are normal with std ``1/sqrt(fan_in)`` times their tile's scale; the
    embedding's std is ``initializer_range``; norm scales are uniform in
    [0.8, 1.2].  ``weights["least_tiles"]`` (per kind) puts that many of
    each matrix's pruned tiles in a lower group of their own."""
    s = _sizes(cfg)
    w = cfg["weights"]
    dt = _DT[cfg["param_dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    prune = cfg["pruning"]
    tile = int(prune["block"][0])
    keep = 1.0 - float(prune["sparsity"])
    least = w.get("least_tiles", {})

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    out = {"embed": normal((s["V"], s["D"]), w["initializer_range"]).to(dt),
           "final_norm": (0.8 + 0.4 * torch.rand((s["D"],), generator=gen,
                                                  device=device)).to(dt)}
    for name in ("pre_norm", "post_norm"):
        out[name] = (0.8 + 0.4 * torch.rand((s["L"], s["D"]), generator=gen,
                                            device=device)).to(dt)
    for name, shape in _shapes(cfg).items():
        x = normal(shape, 1.0 / math.sqrt(shape[-2]))
        lead, k, n = shape[:-2], shape[-2], shape[-1]
        sc = _tile_scale(shape, tile, keep, least.get(name, 0), w["tile_scales"],
                         gen, device)
        x = (x.reshape(*lead, k // tile, tile, n // tile, tile) * sc).reshape(shape)
        out[name] = x.to(dt)
        del x
    if cfg.get("qkv_bias"):
        for name, width in (("bq", s["H"]), ("bk", s["KV"]), ("bv", s["KV"])):
            out[name] = normal((s["L"], width * s["dh"]),
                               w["initializer_range"]).to(dt)
    if s["E"]:
        out["router"] = normal((s["L"], s["D"], s["E"]), 1.0 / math.sqrt(s["D"]))
    return out


def params_tree(w: Dict, cfg: Dict) -> Dict:
    """The port's params tree over the benchmark's stacked weights ``w``
    (views, nothing copied)."""
    layers = []
    for l in range(cfg["num_hidden_layers"]):
        attn = {name: {"kernel": w[name][l]} for name in ("wq", "wk", "wv", "wo")}
        for name in ("q", "k", "v"):
            if f"b{name}" in w:
                attn[f"w{name}"]["bias"] = w[f"b{name}"][l]
        layer = {"pre_norm": {"scale": w["pre_norm"][l]}, "attn": attn,
                 "post_norm": {"scale": w["post_norm"][l]}}
        if "router" in w:
            layer["moe"] = {"router": {"kernel": w["router"][l]},
                            **{k: w[k][l] for k in ("experts_up", "experts_gate",
                                                    "experts_down")}}
        else:
            layer["mlp"] = {k: {"kernel": w[k][l]}
                            for k in ("w_up", "w_gate", "w_down")}
        layers.append(layer)
    return {"embed": {"embedding": w["embed"]}, "layers": layers,
            "final_norm": {"scale": w["final_norm"]}}


def dense_weights_per_token(cfg: Dict) -> int:
    """Weights a token multiplies in matrices that pruning leaves dense,
    besides the routers and the tied head that the plan counts: none."""
    return 0


def other_flops_per_token(cfg: Dict) -> int:
    """Operations of a token outside matrix products and attention over
    its positions (a recurrent scan, say): none counted."""
    return 0


def tile_norms(x: torch.Tensor, tile: int) -> torch.Tensor:
    """fp32 L2 norms of the ``tile x tile`` tiles of each trailing
    matrix of ``x``: (..., K/tile, N/tile)."""
    *lead, k, n = x.shape
    t = x.to(torch.float32).reshape(*lead, k // tile, tile, n // tile, tile)
    return torch.sqrt(torch.sum(t * t, dim=(-3, -1)))


@torch.no_grad()
def select_tiles(weights: Dict[str, torch.Tensor], cfg: Dict,
                 sparsity: Optional[float] = None,
                 embedding: bool = False) -> Dict[str, torch.Tensor]:
    """Kept-tile flags (bool, (L, ..., K/tile, N/tile)) of every prunable
    kind, and of the embedding with ``embedding``.  A leaf is one layer's
    matrix of a kind (an expert kind's leaf holds all its experts; the
    embedding is one leaf); its tile norms are divided by its largest,
    and the ``floor((1 - s) * n)`` largest values over all leaves are
    kept.  Raises where the kept and the first dropped value lie within
    1e-3 of each other: the selection would then hang on rounding."""
    prune = cfg["pruning"]
    tile = int(prune["block"][0])
    s = float(prune["sparsity"] if sparsity is None else sparsity)
    kinds = prunable_kinds(cfg) + (["embed"] if embedding else [])
    norms = {k: tile_norms(weights[k], tile) for k in kinds}
    if embedding:
        norms["embed"] = norms["embed"][None]                  # one leaf
    values = []
    for t in norms.values():
        flat = t.reshape(t.shape[0], -1)                       # one row per leaf
        values.append((flat / flat.max(dim=1, keepdim=True).values).reshape(-1))
    v = torch.cat(values).to(torch.float64)
    n = v.numel()
    k = int(math.floor((1.0 - s) * n + 1e-9))
    order = torch.argsort(v, descending=True, stable=True)
    if 0 < k < n:
        a, b = float(v[order[k - 1]]), float(v[order[k]])
        if a - b < 1e-3 * a:
            raise ValueError(f"tile selection is ambiguous: the last kept "
                             f"value {a} and the first dropped {b} are within "
                             f"1e-3")
    keep = torch.zeros(n, dtype=torch.bool, device=v.device)
    keep[order[:k]] = True
    out, off = {}, 0
    for name, t in norms.items():
        out[name] = keep[off:off + t.numel()].reshape(t.shape)
        off += t.numel()
    if embedding:
        out["embed"] = out["embed"][0]
    return out


def _expand(flags: torch.Tensor, tile: int) -> torch.Tensor:
    return flags.repeat_interleave(tile, dim=-2).repeat_interleave(tile, dim=-1)


@torch.no_grad()
def masked(weights: Dict[str, torch.Tensor], keep: Dict[str, torch.Tensor],
           cfg: Dict) -> Dict[str, torch.Tensor]:
    """fp32 copies of the weights with every dropped tile zero."""
    tile = int(cfg["pruning"]["block"][0])
    out = {}
    for name, x in weights.items():
        x = x.to(torch.float32)
        if name in keep:
            x = x * _expand(keep[name], tile).to(torch.float32)
        out[name] = x
    return out


@torch.no_grad()
def quantized(fp32: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The control: every matrix rounded to fp8 e4m3 with one scale per
    matrix (its largest |value| maps to e4m3's 448), then widened back to
    fp32; norm scales and biases stay as they are."""
    out = {}
    for name, x in fp32.items():
        if x.ndim < 2 or name.endswith("norm"):
            out[name] = x
            continue
        amax = x.abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1e-30)
        scale = 448.0 / amax
        out[name] = (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return out


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta):
    """Half-split rotary embedding of x (S, heads, dh) at positions pos."""
    dh = x.shape[-1]
    half = dh // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=x.device) / half))
    ang = (pos.to(torch.float64)[:, None] * inv).to(torch.float32)
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _moe(w, l, x, s):
    """Top-k mixture of SiLU-gated experts over tokens x (S, D), no
    capacity: every routed token is computed."""
    probs = torch.softmax(x @ w["router"][l], dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :s["K"]], expert[:, :s["K"]]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(s["E"]):
        tok, slot = torch.nonzero(expert == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = torch.nn.functional.silu(xe @ w["experts_gate"][l, e]) * \
            (xe @ w["experts_up"][l, e])
        y.index_add_(0, tok, (h @ w["experts_down"][l, e]) * gate[tok, slot, None])
    return y


@torch.no_grad()
def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """fp32 logits (S, V) of one sequence ``tokens`` (S,) under fp32
    weights ``w`` (from :func:`masked` or :func:`quantized`), layer by
    layer."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(w, tokens, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _forward(w, tokens, cfg):
    s = _sizes(cfg)
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = w["embed"][tokens.long()]
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    group = s["H"] // s["KV"]
    for l in range(s["L"]):
        xn = _rms(x, w["pre_norm"][l], eps)
        q, k, v = xn @ w["wq"][l], xn @ w["wk"][l], xn @ w["wv"][l]
        if "bq" in w:
            q, k, v = q + w["bq"][l], k + w["bk"][l], v + w["bv"][l]
        q = _rope(q.view(S, s["H"], s["dh"]), pos, theta)
        k = _rope(k.view(S, s["KV"], s["dh"]), pos, theta)
        v = v.view(S, s["KV"], s["dh"])
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        att = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(s["dh"])
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hqk,khd->qhd", att, v).reshape(S, s["H"] * s["dh"])
        del att
        x = x + o @ w["wo"][l]
        xn = _rms(x, w["post_norm"][l], eps)
        if s["E"]:
            x = x + _moe(w, l, xn, s)
        else:
            h = torch.nn.functional.silu(xn @ w["w_gate"][l]) * (xn @ w["w_up"][l])
            x = x + h @ w["w_down"][l]
    x = _rms(x, w["final_norm"], eps)
    return x @ w["embed"].T
