"""Decoder stack — torch port of ``src/repro/models/transformer.py``.

``layer_specs`` cycles ``cfg.mixer_pattern`` (attn | mamba | mlstm |
slstm) and ``cfg.mlp_pattern`` (dense | moe | none) over the layers, as
the reference does, so one function set serves attention LMs, MoE LMs,
the Mamba/attention/MoE hybrid (jamba) and the xLSTM stack; norms are
rmsnorm or layernorm.  An encoder-decoder config (whisper,
``cfg.enc_layers`` > 0) adds a bidirectional encoder over precomputed
frames (``encoder_forward`` :307, sinusoidal positions) and gives every
decoder layer cross-attention over its output, whose K/V
``encode_kv_caches`` (:421) stores in the caches for prefill and
decode.  A VLM config (qwen2-vl) rotates by M-RoPE over (B, S, 3)
positions and lets ``batch["patch_embeds"]`` (B, P, D) replace the
first P token embeddings.  ``cfg.logits_softcap`` caps every logit.
Mixer "none" is the reference's zero mixer (no params, no cache, a zero
update).  With ``cfg.moe_impl == "alltoall"`` under an installed mesh
with a "model" axis and a rule set (``distributed.use_mesh`` /
``axis_rules``), the non-decode MoE layers of ``lm_forward`` and
``lm_prefill`` run the expert-parallel all-to-all
(``moe_alltoall.moe_alltoall_apply``); decode keeps ``moe_decode``, as
in the reference (:281-286, :494, :620-625).  ``lm_forward`` (:321) is
the cache-free training/eval forward, differentiable, with each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` is not "none" (the
counterpart of ``_remat_wrap`` :297: "dots" selectively, keeping the
outputs of the products without batch dims); ``cross_entropy_loss`` (:366) adds
the z-loss.  ``lm_forward``, ``lm_prefill``
(:514) and ``lm_decode`` (:434) run unchanged on packed (BSR) params;
``lm_generate`` (:727) is the decode loop as plain Python, greedy or
sampled.  Token selection (``_nucleus_filter`` :643, ``_select_token``
:665, ``_select_token_rows`` :688) draws its noise from
:mod:`repro_torch.prng`, the port's bit-exact threefry, so a sampled
stream can be held against the reference's.

Caches (``init_caches`` :391) are K/V for attention layers and the
recurrent state for the others; they are updated in place and also
returned, so callers written against the reference's functional
signature keep working.

The same functions run the sharded program: given DTensor params,
batches and caches under an installed mesh and rules, the reference's
``logical_constraint``s (:129, :347, :451, :578 and in the layers) place
the activations, and ``cross_entropy_loss`` takes its terms
vocab-parallel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (axis_rules, batch_placements,
                                              current_mesh, current_rules,
                                              is_dtensor,
                                              logical_constraint, reduce_partial,
                                              shard_extent, shard_map, use_mesh)
from .attention import (
    _split_heads,
    attention_apply,
    attention_decode,
    attention_init,
    attention_prefill,
    cross_attention_prefill,
    init_kv_cache,
)
from .ffn import mlp_apply, mlp_init
from .layers import (
    dense,
    embed_init,
    embed_lookup,
    layernorm,
    layernorm_init,
    rmsnorm,
    rmsnorm_init,
    sinusoidal_positions,
    unembed_logits,
)
from .mamba import init_mamba_cache, mamba_apply, mamba_decode, mamba_init, mamba_prefill
from .moe import moe_apply, moe_decode, moe_init
from .moe_alltoall import alltoall_available, moe_alltoall_apply
from .remat import remat_context
from .xlstm import (
    init_mlstm_cache,
    init_slstm_cache,
    mlstm_apply,
    mlstm_decode,
    mlstm_init,
    mlstm_prefill,
    slstm_apply,
    slstm_decode,
    slstm_init,
    slstm_prefill,
)

__all__ = [
    "LayerSpec", "layer_specs", "init_params", "init_caches",
    "lm_forward", "cross_entropy_loss",
    "lm_prefill", "lm_decode", "lm_generate",
    "encoder_forward", "encode_kv_caches",
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


# whisper's encoder layers: bidirectional attention and a dense MLP, no RoPE
ENC_SPEC = LayerSpec(mixer="attn", mlp="dense", causal=False, use_rope=False)


def _stack_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The decoder's specs: an encoder-decoder stack's decoder layers
    are attention with cross-attention and a dense MLP, whatever the
    patterns say (reference :349-351)."""
    if cfg.enc_layers:
        return [LayerSpec(mixer="attn", mlp="dense", cross_attn=True,
                          use_rope=cfg.use_rope)] * cfg.n_layers
    return layer_specs(cfg)


def _check_ported(cfg: ModelConfig) -> List[LayerSpec]:
    """The decoder's specs of ``cfg``, or an error naming what is not
    ported yet."""
    if cfg.norm_type not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(f"{cfg.name}: {cfg.norm_type} is not ported yet")
    specs = _stack_specs(cfg)
    for spec in specs:
        if spec.mixer not in ("attn", "mamba", "mlstm", "slstm", "none"):
            raise NotImplementedError(
                f"{cfg.name}: mixer {spec.mixer!r} is not ported to torch yet")
        if spec.mlp not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: mlp {spec.mlp!r} is not ported to torch yet")
    return specs


def _norm_init(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    init = layernorm_init if cfg.norm_type == "layernorm" else rmsnorm_init
    return init(cfg.d_model, cfg.dtype, device)


def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return layernorm(p, x) if cfg.norm_type == "layernorm" else rmsnorm(p, x)


def _init_mixer(spec: LayerSpec, cfg: ModelConfig, kw) -> Dict:
    if spec.mixer == "attn":
        shape = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim_())
        p = {"attn": attention_init(*shape, qkv_bias=cfg.qkv_bias, **kw)}
        if spec.cross_attn:
            p["cross"] = attention_init(*shape, qkv_bias=cfg.qkv_bias, **kw)
            p["cross_norm"] = _norm_init(cfg, kw["device"])
        return p
    if spec.mixer == "mamba":
        return {"mamba": mamba_init(cfg.d_model, d_state=cfg.d_state,
                                    d_conv=cfg.d_conv, **kw)}
    if spec.mixer == "mlstm":
        return {"mlstm": mlstm_init(cfg.d_model, cfg.n_heads,
                                    proj_factor=cfg.mlstm_proj_factor, **kw)}
    if spec.mixer == "none":
        return {}
    return {"slstm": slstm_init(cfg.d_model, cfg.n_heads, **kw)}


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
    kw = dict(generator=gen, device=device, dtype=cfg.dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(cfg.vocab, cfg.d_model, **kw),
        "layers": [_init_layer(spec, cfg, kw) for spec in specs],
        "final_norm": _norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(cfg.vocab, cfg.d_model, **kw)
    if cfg.enc_layers:
        params["encoder"] = {
            "layers": [_init_layer(ENC_SPEC, cfg, kw)
                       for _ in range(cfg.enc_layers)],
            "final_norm": _norm_init(cfg, device),
        }
    return params


def _init_layer(spec: LayerSpec, cfg: ModelConfig, kw) -> Dict:
    layer = {"pre_norm": _norm_init(cfg, kw["device"]),
             **_init_mixer(spec, cfg, kw)}
    if spec.mlp != "none":
        layer["post_norm"] = _norm_init(cfg, kw["device"])
    if spec.mlp == "moe":
        layer["moe"] = moe_init(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                                gated=cfg.gated_mlp, **kw)
    elif spec.mlp == "dense":
        layer["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp, **kw)
    return layer


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.float32, device=None) -> List[Dict]:
    """Per-layer caches (reference :391): contiguous K/V (B, alloc, K,
    dh) for attention layers, the recurrent state for the others (Mamba's
    conv window in ``dtype``, every other state fp32).  An
    encoder-decoder stack's layers also hold ``cross_k`` / ``cross_v``
    (B, enc_frames, K, dh), zeros until ``encode_kv_caches`` fills
    them."""
    device = resolve_device(device)
    specs = _check_ported(cfg)
    alloc = max_len if cfg.window is None else min(max_len, cfg.window)
    caches = []
    for spec in specs:
        if spec.mixer == "attn":
            c = init_kv_cache(batch, alloc, cfg.kv_heads, cfg.head_dim_(),
                              dtype, device)
            if spec.cross_attn:
                cross = init_kv_cache(batch, cfg.enc_frames, cfg.kv_heads,
                                      cfg.head_dim_(), dtype, device)
                c.update(cross_k=cross["k"], cross_v=cross["v"])
            caches.append(c)
        elif spec.mixer == "mamba":
            caches.append(init_mamba_cache(batch, 2 * cfg.d_model, cfg.d_state,
                                           cfg.d_conv, dtype, device))
        elif spec.mixer == "mlstm":
            d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
            d_in -= d_in % cfg.n_heads
            caches.append(init_mlstm_cache(batch, cfg.n_heads,
                                           d_in // cfg.n_heads, device))
        elif spec.mixer == "none":
            caches.append({})
        else:
            caches.append(init_slstm_cache(batch, cfg.d_model, device))
    return caches


def _accum(cfg: ModelConfig) -> torch.dtype:
    """Output dtype of the row-parallel matmuls (wo, w_down), reference
    :115."""
    return torch.bfloat16 if cfg.row_accum_dtype == "bfloat16" else torch.float32


def _mlp(lp: Dict, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor, *,
         decode: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP half on the residual stream x.  Returns (x, the
    MoE aux loss or None)."""
    if spec.mlp == "none":
        return x, None
    xn = _norm(cfg, lp["post_norm"], x)
    if spec.mlp == "dense":
        # the residual rides the w_down epilogue (fused on packed params)
        return mlp_apply(lp["mlp"], xn, activation=cfg.activation,
                         accum=None if decode else _accum(cfg), residual=x), None
    kw = dict(num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
              activation=cfg.activation)
    if decode:
        y, aux = moe_decode(lp["moe"], xn, **kw)
    elif cfg.moe_impl == "alltoall" and alltoall_available(cfg.moe_experts):
        y, aux = moe_alltoall_apply(lp["moe"], xn,
                                    capacity_factor=cfg.capacity_factor, **kw)
    else:
        y, aux = moe_apply(lp["moe"], xn, capacity_factor=cfg.capacity_factor, **kw)
    return x + y, aux


def _apply_layer(lp: Dict, x: torch.Tensor, positions: Optional[torch.Tensor],
                 enc_out: Optional[torch.Tensor], spec: LayerSpec,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual layer of ``lm_forward`` and the encoder.
    Cross-attention normalizes the raw residual plus the self-attention
    output, ``x + h`` (reference :240-250).  Returns (x, moe_aux)."""
    xn = _norm(cfg, lp["pre_norm"], x)
    heads = dict(num_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                 head_dim=cfg.head_dim_())
    if spec.mixer == "attn":
        h = attention_apply(
            lp["attn"], xn, **heads, positions=positions, causal=spec.causal,
            window=cfg.window, chunk=cfg.attn_chunk, rope_theta=cfg.rope_theta,
            mrope_sections=cfg.mrope_sections, use_rope=spec.use_rope,
            accum=_accum(cfg))
        if spec.cross_attn and enc_out is not None:
            xc = _norm(cfg, lp["cross_norm"], x + h)
            h = h + attention_apply(lp["cross"], xc, **heads, causal=False,
                                    chunk=cfg.attn_chunk, kv_input=enc_out,
                                    use_rope=False)
    elif spec.mixer == "mamba":
        h = mamba_apply(lp["mamba"], xn, chunk=cfg.ssm_chunk)
    elif spec.mixer == "mlstm":
        h = mlstm_apply(lp["mlstm"], xn, num_heads=cfg.n_heads, chunk=cfg.ssm_chunk)
    elif spec.mixer == "none":
        h = torch.zeros_like(xn)
    else:
        h = slstm_apply(lp["slstm"], xn, num_heads=cfg.n_heads)
    x, aux = _mlp(lp, spec, cfg, _residual(cfg, x + h))
    x = _residual(cfg, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _residual(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The residual stream sharded on seq over "res_seq" when
    ``cfg.seq_sharded_acts`` (Megatron sequence parallelism, reference
    :125-130)."""
    if cfg.seq_sharded_acts:
        return logical_constraint(x, "batch", "res_seq", "embed")
    return x


def _in_context(fn, mesh, rules, *args):
    with use_mesh(mesh), axis_rules(rules):
        return fn(*args)


def _run_layer(lp, x, positions, enc_out, spec: LayerSpec, cfg: ModelConfig):
    """``_apply_layer``, under ``cfg.remat``'s policy in the backward
    pass (``remat.remat_context``; ``torch.utils.checkpoint``,
    non-reentrant): "none" runs it plainly; "dots" keeps the fp32 outputs
    of the products without batch dims (the projections and the router)
    and recomputes the rest; "full" and any other name keep only the
    layer's inputs.  The recomputation runs under the mesh and rules
    of the forward: the backward of CUDA tensors runs on autograd's own
    thread, which does not see this thread's context, and would route
    the MoE otherwise."""
    layer = functools.partial(_apply_layer, spec=spec, cfg=cfg)
    if cfg.remat != "none" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            functools.partial(_in_context, layer, current_mesh(), current_rules()),
            lp, x, positions, enc_out, use_reentrant=False,
            context_fn=remat_context(cfg.remat))
    return layer(lp, x, positions, enc_out)


def encoder_forward(params: Dict, frames: torch.Tensor, cfg: ModelConfig
                    ) -> torch.Tensor:
    """Whisper's encoder (reference :307) over precomputed frame
    embeddings (B, T, D), the conv frontend being a stub: sinusoidal
    positions added, bidirectional attention layers, the final norm.
    Returns (B, T, D) in ``cfg.adtype``."""
    x = frames.to(cfg.adtype)
    pos = sinusoidal_positions(frames.shape[1], cfg.d_model, device=x.device)
    x = x + pos.to(cfg.adtype)[None]
    for lp in params["encoder"]["layers"]:
        x = _run_layer(lp, x, None, None, ENC_SPEC, cfg)[0]
    return _norm(cfg, params["encoder"]["final_norm"], x)


def _embed(params: Dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
           start_pos: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings, the first P replaced by ``batch["patch_embeds"]``
    (B, P, D) on a VLM config, and the positions: ``batch["positions"]``
    or ``[start_pos, start_pos + S)``, tiled to (B, S, 3) under M-RoPE
    (reference :330-341, :546-558)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, dtype=cfg.adtype)
    if cfg.num_patches > 0 and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(cfg.adtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(start_pos, start_pos + s, device=x.device)
        if cfg.mrope_sections is not None:
            positions = positions[None, :, None].expand(b, s, 3)
        else:
            positions = positions[None].expand(b, s)
    return x, positions


def lm_forward(params: Dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward to fp32 logits (B, S, V) over batch["tokens"] (B, S)
    [, positions, patch_embeds, frames], with no cache.  Returns
    (logits, {"moe_aux": fp32 scalar summed over the layers}).  With
    ``cfg.remat`` other than "none" each layer's activations are
    recomputed in the backward pass (``_run_layer``)."""
    specs = _check_ported(cfg)
    x, positions = _embed(params, batch, cfg)
    x = logical_constraint(x, "batch", "seq", "embed")
    enc_out = encoder_forward(params, batch["frames"], cfg) if cfg.enc_layers else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, spec in zip(params["layers"], specs):
        x, aux = _run_layer(lp, x, positions, enc_out, spec, cfg)
        aux_total = aux_total + aux
    return _unembed(params, cfg, x), {"moe_aux": aux_total}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean cross-entropy of fp32 logits (B, S, V) plus the z-loss
    ``z_loss * mean(logsumexp^2)``.  The label logit is gathered; the
    reference's one-hot sum (:378) has a single nonzero term, so the
    value is the same, without a (B, S, V) one-hot.  On DTensor logits
    both terms are taken vocab-parallel (``_vocab_parallel_terms``)."""
    if is_dtensor(logits):
        lse, ll = _vocab_parallel_terms(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def _vocab_parallel_terms(logits, labels):
    """(log-sum-exp, label logit) of vocab-sharded DTensor logits without
    gathering them, as ``loss_parallel`` takes them: the max, the sum of
    exponentials and the label logit are reduced per vocab shard, then
    over the shards (a max, a sum and a sum over "model"), so every rank
    sees (B, S) terms.  The label logit is the reference's one-hot sum
    (:378), taken on each rank's shard (its slice of the vocab, a partial
    sum over "model" where the vocab is sharded), so its backward is
    local too: left to DTensor, the backward of the one-hot select
    gathered the batch over "data" on a ("pod", "data") batch."""
    from torch.distributed.tensor import Partial

    m = reduce_partial(logits.detach().amax(dim=-1, keepdim=True))
    lse = torch.log(reduce_partial(torch.exp(logits - m).sum(dim=-1))) + m[..., 0]
    v_off, v_len = shard_extent(logits, 2)
    placements = tuple(logits.placements)

    def label_logit(lg, lab):
        ids = torch.arange(v_off, v_off + v_len, device=lg.device)
        hit = lab.long()[..., None] == ids
        return torch.where(hit, lg, torch.zeros((), dtype=lg.dtype,
                                                device=lg.device)).sum(dim=-1)

    ll = shard_map(label_logit,
                   in_placements=(placements, batch_placements(logits)),
                   out_placements=tuple(Partial() if pl.is_shard(2) else pl
                                        for pl in placements))(logits, labels)
    return lse, reduce_partial(ll)


def _unembed(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, fp32 logits, ``cfg.logits_softcap`` applied (reference
    :361, :503, :638)."""
    x = _norm(cfg, params["final_norm"], x)
    logits = unembed_logits(params.get("lm_head", params["embed"]), x)
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def encode_kv_caches(params: Dict, enc_out: torch.Tensor, cfg: ModelConfig,
                     caches: List[Dict]) -> List[Dict]:
    """The decoder layers' cross-attention K/V of the encoder output
    (B, T, D), stored as each cache's ``cross_k`` / ``cross_v`` in its
    dtype (reference :421).  Returns the caches."""
    for lp, c in zip(params["layers"], caches):
        k = _split_heads(dense(lp["cross"]["wk"], enc_out), cfg.kv_heads)
        v = _split_heads(dense(lp["cross"]["wv"], enc_out), cfg.kv_heads)
        c["cross_k"] = k.to(c["cross_k"].dtype)
        c["cross_v"] = v.to(c["cross_v"].dtype)
    return caches


def lm_decode(params: Dict, caches: List[Dict], batch: Dict[str, torch.Tensor],
              cache_len, cfg: ModelConfig) -> Tuple[torch.Tensor, List[Dict]]:
    """One-token decode.  batch["tokens"] (B, 1); with
    batch["page_tables"] (B, max_pages) the attention caches are page
    pools (the recurrent ones stay per-row).  Returns (fp32 logits
    (B, 1, V), caches)."""
    tokens = batch["tokens"]
    page_tables = batch.get("page_tables")
    x = embed_lookup(params["embed"], tokens, dtype=cfg.adtype)
    x = logical_constraint(x, "batch", None, "embed")
    heads = dict(num_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                 head_dim=cfg.head_dim_())
    for lp, spec, cache in zip(params["layers"], _stack_specs(cfg), caches):
        xn = _norm(cfg, lp["pre_norm"], x)
        if spec.mixer == "attn":
            h, _ = attention_decode(
                lp["attn"], xn, cache, cache_len, **heads, window=cfg.window,
                rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
                use_rope=spec.use_rope, page_table=page_tables)
            if spec.cross_attn:
                xc = _norm(cfg, lp["cross_norm"], x + h)
                hc, _ = attention_decode(
                    lp["cross"], xc, {"k": cache["cross_k"], "v": cache["cross_v"]},
                    cache["cross_k"].shape[1], **heads, update_cache=False)
                h = h + hc
        elif spec.mixer == "mamba":
            h, _ = mamba_decode(lp["mamba"], xn, cache)
        elif spec.mixer == "mlstm":
            h, _ = mlstm_decode(lp["mlstm"], xn, cache, num_heads=cfg.n_heads)
        elif spec.mixer == "none":
            h = torch.zeros_like(x)
        else:
            h, _ = slstm_decode(lp["slstm"], xn, cache, num_heads=cfg.n_heads)
        x, _ = _mlp(lp, spec, cfg, x + h, decode=True)
    return _unembed(params, cfg, x), caches


def lm_prefill(params: Dict, caches: List[Dict], batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, start_pos: int = 0
               ) -> Tuple[torch.Tensor, List[Dict]]:
    """Cache-filling prefill over batch["tokens"] (B, S) [, positions,
    patch_embeds].  With batch["page_tables"] the attention caches are
    pools and K/V go straight into the rows' pages; ``start_pos > 0``
    runs the tail-only prefill of a prefix-cache hit (tokens at
    ``[start_pos, start_pos + S)``; attention-only stacks without
    cross-attention: a recurrent or cross-attention state cannot resume
    from pages).  An encoder-decoder stack reads the cross K/V that
    ``encode_kv_caches`` stored.  Returns (fp32 logits (B, S, V), caches
    ready for ``cache_len = start_pos + S``)."""
    specs = _stack_specs(cfg)
    page_tables = batch.get("page_tables")
    if start_pos:
        if page_tables is None:
            raise ValueError(
                "lm_prefill: start_pos > 0 needs page_tables — the cached "
                "prefix lives in shared pool pages")
        bad = sorted({sp.mixer for sp in specs if sp.mixer != "attn"})
        if bad or cfg.enc_layers:
            raise ValueError(
                "lm_prefill: start_pos > 0 needs an attention-only stack — "
                f"recurrent/cross-attn mixers ({bad or ['cross-attn']}) carry "
                "state the cached pages do not hold")
    x, positions = _embed(params, batch, cfg, start_pos)
    x = logical_constraint(x, "batch", "seq", "embed")
    heads = dict(num_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                 head_dim=cfg.head_dim_())
    for lp, spec, cache in zip(params["layers"], specs, caches):
        xn = _norm(cfg, lp["pre_norm"], x)
        if spec.mixer == "attn":
            h, _ = attention_prefill(
                lp["attn"], xn, cache, **heads, positions=positions,
                window=cfg.window, chunk=cfg.attn_chunk,
                rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
                use_rope=spec.use_rope, accum=_accum(cfg),
                page_table=page_tables, start_pos=start_pos)
            if spec.cross_attn:
                xc = _norm(cfg, lp["cross_norm"], x + h)
                h = h + cross_attention_prefill(lp["cross"], xc, cache, **heads,
                                                chunk=cfg.attn_chunk)
        elif spec.mixer == "mamba":
            h, _ = mamba_prefill(lp["mamba"], xn, cache, chunk=cfg.ssm_chunk)
        elif spec.mixer == "mlstm":
            h, _ = mlstm_prefill(lp["mlstm"], xn, cache, num_heads=cfg.n_heads,
                                 chunk=cfg.ssm_chunk)
        elif spec.mixer == "none":
            h = torch.zeros_like(x)
        else:
            h, _ = slstm_prefill(lp["slstm"], xn, cache, num_heads=cfg.n_heads)
        x, _ = _mlp(lp, spec, cfg, x + h)
    return _unembed(params, cfg, x), caches


def _ranks(x: torch.Tensor) -> torch.Tensor:
    """Each entry's position in a stable descending sort of the last
    axis (ties by index) — ``argsort(argsort(-x))``, with the inverse
    permutation scattered instead of sorted."""
    order = torch.argsort(-x, dim=-1, stable=True)
    pos = torch.arange(x.shape[-1], device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def _nucleus_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Top-p mask: keep the smallest prefix of the probability-sorted
    vocab whose mass reaches ``top_p`` (at least the top-1 token), the
    rest to -inf.  The keep set is decided by position after a stable
    descending sort (ties by vocab id) and scattered back, so tokens
    tied at the threshold are not all kept.  ``top_p`` is a float or a
    tensor broadcasting against ``logits[..., :1]``."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    srt = torch.gather(logits, -1, order)
    probs = torch.softmax(srt, dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, float("-inf"))


def _select_token(logits: torch.Tensor, rng: torch.Tensor, *,
                  temperature: float, top_k: Optional[int],
                  top_p: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy argmax (temperature <= 0) or filtered sampling of (B, V)
    logits with one key ``rng`` (2,).  Returns ((B,) int32 tokens, the
    advanced key)."""
    if not temperature or temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32), rng
    lg = logits.to(torch.float32) / temperature
    if top_k is not None and 0 < top_k < lg.shape[-1]:
        lg = torch.where(_ranks(lg) < top_k, lg, float("-inf"))
    if top_p is not None and top_p < 1.0:
        lg = _nucleus_filter(lg, top_p)
    keys = prng.split(rng)
    return prng.categorical(keys[1], lg).to(torch.int32), keys[0]


def _select_token_rows(logits: torch.Tensor, rngs: torch.Tensor,
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row selection with ``(B,)`` sampling params and ``(B, 2)``
    keys — each row as :func:`_select_token` would pick it alone, bit
    for bit: a disabled filter (``top_k`` outside (0, V), ``top_p`` >= 1)
    selects the unfiltered logits, greedy rows (temperature <= 0) keep
    their key, sampled rows split theirs exactly once.  Device ops only,
    no host sync.  Returns ((B,) int32 tokens, advanced keys)."""
    v = logits.shape[-1]
    lg = logits.to(torch.float32)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    t = temperature.to(torch.float32)
    k = top_k.to(torch.int64)
    p = top_p.to(torch.float32)
    hot = t > 0.0
    scaled = lg / torch.where(hot, t, torch.ones_like(t))[:, None]
    kk = torch.where((k > 0) & (k < v), k, torch.full_like(k, v))
    lk = torch.where(_ranks(scaled) < kk[:, None], scaled, float("-inf"))
    lp = torch.where((p < 1.0)[:, None], _nucleus_filter(lk, p[:, None]), lk)
    keys = prng.split(rngs)                                # (B, 2, 2)
    sampled = prng.categorical(keys[:, 1], lp).to(torch.int32)
    tok = torch.where(hot, sampled, greedy)
    return tok, torch.where(hot[:, None], keys[:, 0], rngs.to(torch.int64))


@torch.no_grad()
def lm_generate(params: Dict, caches: List[Dict], first_token: torch.Tensor,
                start_len, num_tokens: int, cfg: ModelConfig, *,
                temperature: float = 0.0, top_k: Optional[int] = None,
                top_p: Optional[float] = None, eos_id: Optional[int] = None,
                key: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """Decode ``num_tokens`` tokens, greedy (``temperature`` <= 0) or
    sampled with ``top_k``/``top_p`` from ``key`` (default
    ``PRNGKey(0)``), the key split once per step as in the reference.
    Emits the running token before each step (``tokens[:, 0] ==
    first_token``); with ``eos_id`` finished rows keep emitting it.
    ``start_len`` is a scalar or per-row (B,) cache length.  Returns
    (tokens (B, num_tokens) int32, caches)."""
    tok = first_token.to(torch.int32)
    b = tok.shape[0]
    start = torch.as_tensor(start_len, device=tok.device).reshape(-1)
    start = start.expand(b).to(torch.int64)
    rng = key if key is not None else prng.PRNGKey(0)
    rng = rng.to(device=tok.device, dtype=torch.int64)
    done = torch.zeros((b,), dtype=torch.bool, device=tok.device)
    out = []
    for i in range(num_tokens):
        emit = tok[:, 0]
        if eos_id is not None:
            done = done | (emit == eos_id)
        out.append(emit)
        logits, caches = lm_decode(params, caches, {"tokens": tok}, start + i, cfg)
        nxt, rng = _select_token(logits[:, -1], rng, temperature=temperature,
                                 top_k=top_k, top_p=top_p)
        nxt = nxt[:, None]
        if eos_id is not None:
            nxt = torch.where(done[:, None], torch.full_like(nxt, eos_id), nxt)
        tok = nxt
    if not out:
        return torch.zeros((b, 0), dtype=torch.int32, device=tok.device), caches
    return torch.stack(out, dim=1), caches
