"""Decoder stack for attention language models with dense-MLP or MoE
layers — torch port of ``src/repro/models/transformer.py``.

``layer_specs``, ``init_params`` and ``init_caches`` cover stacks of
``mixer=attn`` layers with ``mlp=dense`` or ``mlp=moe``; other mixers
(mamba, xLSTM), encoder-decoder stacks and the multi-device MoE
all-to-all raise until they are ported.  ``lm_prefill``
(:514) and ``lm_decode`` (:434) run unchanged on packed (BSR) params;
``lm_generate`` (:727) is the greedy loop as plain Python.

Caches are updated in place and also returned, so callers written
against the reference's functional signature keep working.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from .attention import attention_decode, attention_init, attention_prefill, init_kv_cache
from .ffn import mlp_apply, mlp_init
from .layers import embed_init, embed_lookup, rmsnorm, rmsnorm_init, unembed_logits
from .moe import moe_apply, moe_decode, moe_init

__all__ = [
    "LayerSpec", "layer_specs", "init_params", "init_caches",
    "lm_prefill", "lm_decode", "lm_generate",
]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                 # attn | mamba | mlstm | slstm | none
    mlp: str                   # dense | moe | none
    cross_attn: bool = False
    causal: bool = True
    use_rope: bool = True


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    mix = cfg.mixer_pattern or ("attn",)
    mlp = cfg.mlp_pattern or ("dense",)
    return [
        LayerSpec(mixer=mix[i % len(mix)], mlp=mlp[i % len(mlp)],
                  use_rope=cfg.use_rope)
        for i in range(cfg.n_layers)
    ]


def _check_ported(cfg: ModelConfig) -> List[LayerSpec]:
    """The specs of ``cfg``, or an error naming what is not ported yet."""
    if cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder stacks are not ported to torch yet")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is not ported to torch yet")
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"{cfg.name}: {cfg.norm_type} is not ported yet")
    if cfg.logits_softcap:
        raise NotImplementedError(f"{cfg.name}: logit softcap is not ported yet")
    specs = layer_specs(cfg)
    for spec in specs:
        if spec.mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: mixer {spec.mixer!r} is not ported to torch yet")
        if spec.mlp not in ("dense", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: mlp {spec.mlp!r} is not ported to torch yet")
    if cfg.moe_impl == "alltoall" and any(sp.mlp == "moe" for sp in specs):
        raise NotImplementedError(
            f"{cfg.name}: moe_impl='alltoall' (expert-parallel all-to-all "
            "across devices) is not ported to torch yet")
    return specs


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random params from a seeded generator on ``device`` (default the
    card; pass ``device="cpu"`` explicitly for the CPU).  Weights are
    truncated normals drawn in layer order; the reference's PRNG is
    JAX's and gives other numbers for the same seed."""
    device = resolve_device(device)
    specs = _check_ported(cfg)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    dt, hd = cfg.dtype, cfg.head_dim_()
    params: Dict[str, Any] = {
        "embed": embed_init(cfg.vocab, cfg.d_model, generator=gen,
                            device=device, dtype=dt),
        "layers": [],
        "final_norm": rmsnorm_init(cfg.d_model, dt, device),
    }
    for spec in specs:
        layer = {
            "pre_norm": rmsnorm_init(cfg.d_model, dt, device),
            "attn": attention_init(cfg.d_model, cfg.n_heads, cfg.kv_heads, hd,
                                   generator=gen, device=device,
                                   qkv_bias=cfg.qkv_bias, dtype=dt),
            "post_norm": rmsnorm_init(cfg.d_model, dt, device),
        }
        if spec.mlp == "moe":
            layer["moe"] = moe_init(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                                    generator=gen, device=device,
                                    gated=cfg.gated_mlp, dtype=dt)
        else:
            layer["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, generator=gen,
                                    device=device, gated=cfg.gated_mlp, dtype=dt)
        params["layers"].append(layer)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(cfg.vocab, cfg.d_model, generator=gen,
                                       device=device, dtype=dt)
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.float32, device=None) -> List[Dict]:
    """Contiguous per-layer K/V caches (B, alloc, K, dh)."""
    device = resolve_device(device)
    specs = _check_ported(cfg)
    alloc = max_len if cfg.window is None else min(max_len, cfg.window)
    return [init_kv_cache(batch, alloc, cfg.kv_heads, cfg.head_dim_(), dtype,
                          device) for _ in specs]


def _unembed(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x)
    return unembed_logits(params.get("lm_head", params["embed"]), x)


def lm_decode(params: Dict, caches: List[Dict], batch: Dict[str, torch.Tensor],
              cache_len, cfg: ModelConfig) -> Tuple[torch.Tensor, List[Dict]]:
    """One-token decode.  batch["tokens"] (B, 1); with
    batch["page_tables"] (B, max_pages) the caches are page pools.
    Returns (fp32 logits (B, 1, V), caches)."""
    tokens = batch["tokens"]
    page_tables = batch.get("page_tables")
    x = embed_lookup(params["embed"], tokens, dtype=cfg.adtype)
    for lp, cache in zip(params["layers"], caches):
        h, _ = attention_decode(
            lp["attn"], rmsnorm(lp["pre_norm"], x), cache, cache_len,
            num_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim_(), window=cfg.window,
            rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
            page_table=page_tables)
        x = x + h
        if "moe" in lp:
            y, _ = moe_decode(lp["moe"], rmsnorm(lp["post_norm"], x),
                              num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                              activation=cfg.activation)
            x = x + y
        else:
            x = mlp_apply(lp["mlp"], rmsnorm(lp["post_norm"], x),
                          activation=cfg.activation, residual=x)
    return _unembed(params, cfg, x), caches


def lm_prefill(params: Dict, caches: List[Dict], batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, start_pos: int = 0
               ) -> Tuple[torch.Tensor, List[Dict]]:
    """Cache-filling prefill over batch["tokens"] (B, S).  With
    batch["page_tables"] the caches are pools and K/V go straight into the
    rows' pages; ``start_pos > 0`` runs the tail-only prefill of a
    prefix-cache hit (tokens at ``[start_pos, start_pos + S)``).  Returns
    (fp32 logits (B, S, V), caches ready for ``cache_len = start_pos+S``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    page_tables = batch.get("page_tables")
    if start_pos and page_tables is None:
        raise ValueError(
            "lm_prefill: start_pos > 0 needs page_tables — the cached "
            "prefix lives in shared pool pages")
    x = embed_lookup(params["embed"], tokens, dtype=cfg.adtype)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(start_pos, start_pos + s,
                                 device=x.device)[None].expand(b, s)
    for lp, cache in zip(params["layers"], caches):
        h, _ = attention_prefill(
            lp["attn"], rmsnorm(lp["pre_norm"], x), cache,
            num_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim_(), positions=positions, window=cfg.window,
            chunk=cfg.attn_chunk, rope_theta=cfg.rope_theta,
            use_rope=cfg.use_rope, page_table=page_tables,
            start_pos=start_pos)
        x = x + h
        if "moe" in lp:
            y, _ = moe_apply(lp["moe"], rmsnorm(lp["post_norm"], x),
                             num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                             capacity_factor=cfg.capacity_factor,
                             activation=cfg.activation)
            x = x + y
        else:
            # the residual rides the w_down epilogue
            x = mlp_apply(lp["mlp"], rmsnorm(lp["post_norm"], x),
                          activation=cfg.activation, residual=x)
    return _unembed(params, cfg, x), caches


@torch.no_grad()
def lm_generate(params: Dict, caches: List[Dict], first_token: torch.Tensor,
                start_len, num_tokens: int, cfg: ModelConfig, *,
                eos_id: Optional[int] = None) -> Tuple[torch.Tensor, List[Dict]]:
    """Greedy decode of ``num_tokens`` tokens.  Emits the running token
    before each step (``tokens[:, 0] == first_token``); with ``eos_id``
    finished rows keep emitting it.  ``start_len`` is a scalar or per-row
    (B,) cache length.  Returns (tokens (B, num_tokens) int32, caches)."""
    tok = first_token.to(torch.int32)
    b = tok.shape[0]
    start = torch.as_tensor(start_len, device=tok.device).reshape(-1)
    start = start.expand(b).to(torch.int64)
    done = torch.zeros((b,), dtype=torch.bool, device=tok.device)
    out = []
    for i in range(num_tokens):
        emit = tok[:, 0]
        if eos_id is not None:
            done = done | (emit == eos_id)
        out.append(emit)
        logits, caches = lm_decode(params, caches, {"tokens": tok}, start + i, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        if eos_id is not None:
            nxt = torch.where(done[:, None], torch.full_like(nxt, eos_id), nxt)
        tok = nxt
    if not out:
        return torch.zeros((b, 0), dtype=torch.int32, device=tok.device), caches
    return torch.stack(out, dim=1), caches
