"""The port's model stack against the JAX package, on the CPU.

The qwen1.5-0.5b smoke config (fp32, vocab 256, d_model 128, 4 layers)
is initialised in JAX and carried over with ``repro_torch.bridge``, dense
and knapsack-pruned + BSR-packed.  ``lm_prefill`` and ``lm_decode``
logits agree within 1e-4 on contiguous and paged caches (page tables
with shuffled pool pages, a prefix-hit tail at ``start_pos > 0``), and
``lm_generate``'s greedy tokens are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import lm_decode, lm_generate, lm_prefill
from repro.models.layers import apply_rope as japply_rope
from repro.models.layers import rmsnorm as jrmsnorm
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.models import init_caches
from repro_torch.models import lm_decode as tlm_decode
from repro_torch.models import lm_forward as tlm_forward
from repro_torch.models import lm_generate as tlm_generate
from repro_torch.models import lm_prefill as tlm_prefill
from repro_torch.models.attention import attention_decode, attention_prefill
from repro_torch.models.layers import apply_rope, rmsnorm

TOL = 1e-4
_CACHE = {}
# the reference runs jitted (one compile per shape instead of op by op)
jlm_prefill = jax.jit(lm_prefill, static_argnames=("cfg", "start_pos"))
jlm_decode = jax.jit(lm_decode, static_argnames=("cfg",))
jlm_generate = jax.jit(lm_generate, static_argnames=("num_tokens", "cfg"))


def _models():
    """(jax cfg, torch cfg, {kind: (jax params, torch params)})."""
    if not _CACHE:
        jcfg = jmake_smoke(jget_config("qwen1.5-0.5b"))
        cfg = make_smoke(get_config("qwen1.5-0.5b"))
        assert (cfg.vocab, cfg.d_model, cfg.n_layers) == (256, 128, 4)
        jdense = jinit_params(jax.random.PRNGKey(0), jcfg)
        sel = jknapsack_prune(jdense, sparsity=0.5,
                              blocking=JBlockingSpec(bk=32, bn=32), min_size=1024)
        jpacked = jpack_params(jdense, sel.masks, sel.structures)
        _CACHE.update(jcfg=jcfg, cfg=cfg, params={
            "dense": (jdense, params_from_reference(jdense)),
            "packed": (jpacked, params_from_reference(jpacked)),
        })
    return _CACHE["jcfg"], _CACHE["cfg"], _CACHE["params"]


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = np.tile(np.arange(3, 8)[None], (2, 1)).astype(np.int32)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=1e6).numpy(),
        np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6)),
        atol=1e-6)
    scale = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy(),
        np.asarray(jrmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=1e-6)


def _row_accum_logits(accum, seeds=range(8)):
    """(jax cfg, torch cfg, jax params, per seed: tokens (2, 9) and the
    reference's ``lm_prefill`` logits) of the qwen smoke model with
    ``row_accum_dtype=accum``."""
    jcfg = jmake_smoke(jget_config("qwen1.5-0.5b"), row_accum_dtype=accum)
    cfg = make_smoke(get_config("qwen1.5-0.5b"), row_accum_dtype=accum)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    runs = []
    for seed in seeds:
        tokens = np.random.default_rng(seed).integers(
            0, cfg.vocab, size=(2, 9)).astype(np.int32)
        runs.append((tokens, _jprefill_logits(jp, jcfg, tokens)))
    return jcfg, cfg, jp, runs


def _jprefill_logits(jp, jcfg, tokens):
    jl, _ = lm_prefill(jp, jinit_caches(jcfg, *tokens.shape, jnp.float32),
                       {"tokens": jnp.asarray(tokens)}, cfg=jcfg)
    return np.asarray(jl)


def _reordered(jp, n_heads):
    """The same model with its heads reversed and its MLP hidden units
    permuted: every function is unchanged, but the wo and w_down
    contractions sum their terms in another order."""
    ff = np.random.default_rng(0).permutation(jp["layers"][0]["mlp"]["w_down"]["kernel"].shape[0])
    d = jp["layers"][0]["attn"]["wo"]["kernel"].shape[0] // n_heads
    heads = (np.arange(n_heads)[::-1, None] * d + np.arange(d)[None]).reshape(-1)
    layers = []
    for lp in jp["layers"]:
        attn = {k: {kk: (vv[heads, :] if k == "wo" else vv[..., heads])
                    for kk, vv in w.items()} for k, w in lp["attn"].items()}
        mlp = {"w_gate": {"kernel": lp["mlp"]["w_gate"]["kernel"][:, ff]},
               "w_up": {"kernel": lp["mlp"]["w_up"]["kernel"][:, ff]},
               "w_down": {"kernel": lp["mlp"]["w_down"]["kernel"][ff, :]}}
        layers.append({**lp, "attn": attn, "mlp": mlp})
    return {**jp, "layers": layers}


def _drift(diffs):
    """(share of positions whose logits all agree within TOL, median,
    max) of a stack of |logit differences|."""
    d = np.stack(diffs)
    return (d.max(-1) <= TOL).mean(), np.median(d), d.max()


def test_row_accum_bfloat16_prefill_matches_reference(monkeypatch):
    """``row_accum_dtype="bfloat16"`` rounds the wo and w_down outputs to
    bf16 (reference ``_accum``, transformer.py:115), in ``lm_prefill``
    and ``lm_forward`` alike: each forward makes exactly 2 x n_layers
    matmuls accumulated in bf16.  Where two fp32 sums differ in their
    last bit, a bf16 rounding can land one ulp apart and that position
    and the later ones of its row drift; the reference does the same
    against itself under another summation order
    (``test_row_accum_bfloat16_drift_is_the_reference_own``).  So, over 8
    batches of B 2, S 9: at least half of the positions agree within
    1e-4, the median is within 1e-4 and the largest |difference| is
    under 0.05.  Ignoring the field (computing in fp32) agrees at no
    position, with median 0.013 and max 0.099."""
    from repro_torch.models import layers

    jcfg, cfg, jp, runs = _row_accum_logits("bfloat16")
    tp = params_from_reference(jp)
    plain = layers.matmul
    accums = []

    def matmul(x, w, *, accum=torch.float32, epilogue=None):
        accums.append(accum)
        return plain(x, w, accum=accum, epilogue=epilogue)

    monkeypatch.setattr(layers, "matmul", matmul)
    diffs, fwd = [], []
    for tokens, jl in runs:
        with torch.no_grad():
            del accums[:]
            tl, _ = tlm_prefill(tp, init_caches(cfg, 2, 9, torch.float32,
                                                device="cpu"),
                                {"tokens": torch.from_numpy(tokens)}, cfg)
            assert accums.count(torch.bfloat16) == 2 * cfg.n_layers
            del accums[:]
            tf, _ = tlm_forward(tp, {"tokens": torch.from_numpy(tokens)}, cfg)
            assert accums.count(torch.bfloat16) == 2 * cfg.n_layers
        diffs.append(np.abs(tl.numpy() - jl))
        fwd.append(np.abs(tf.numpy() - jl))
    for d in (diffs, fwd):
        share, median, worst = _drift(d)
        assert share >= 0.5 and median <= TOL and worst < 0.05, (share, median, worst)


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_row_accum_bfloat16_drift_is_the_reference_own(accum):
    """Witness for the tolerance above: the reference against itself,
    with the same model's heads and MLP units reordered (another
    summation order in wo and w_down, the same function).  In fp32 every
    logit agrees within 1e-4, as every fp32 parity test here asks.  With bf16 row accumulation whole
    positions drift: fewer than 90 % agree within 1e-4 and the largest
    |difference| passes 1e-3, as between the port and the reference."""
    jcfg, _, jp, runs = _row_accum_logits(accum)
    other = _reordered(jp, jcfg.n_heads)
    share, median, worst = _drift(
        [np.abs(_jprefill_logits(other, jcfg, tokens) - jl) for tokens, jl in runs])
    if accum == "float32":
        assert worst <= TOL, worst
    else:
        assert median <= TOL and share < 0.9 and worst > 1e-3, (share, median, worst)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_contiguous_prefill_decode_generate_match_reference(kind):
    jcfg, cfg, params = _models()
    jp, tp = params[kind]
    rng = np.random.default_rng(1)
    b, s, gen = 2, 11, 6
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)

    jc = jinit_caches(jcfg, b, s + gen, jnp.float32)
    tc = init_caches(cfg, b, s + gen, torch.float32, device="cpu")
    jl, jc = jlm_prefill(jp, jc, {"tokens": jnp.asarray(tokens)}, cfg=jcfg)
    tl, tc = tlm_prefill(tp, tc, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert tl.dtype == torch.float32 and tl.shape == (b, s, cfg.vocab)
    _close(tl, jl)
    for c_t, c_j in zip(tc, jc):
        _close(c_t["k"], c_j["k"])

    # one ragged decode step (per-row cache_len) on the filled caches
    step = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
    clen = np.array([s, s - 3], np.int32)
    jd, _ = jlm_decode(jp, [dict(c) for c in jc], {"tokens": jnp.asarray(step)},
                       jnp.asarray(clen), cfg=jcfg)
    td, _ = tlm_decode(tp, [{k: v.clone() for k, v in c.items()} for c in tc],
                      {"tokens": torch.from_numpy(step)}, torch.from_numpy(clen),
                      cfg)
    _close(td, jd)

    first = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    assert np.array_equal(first, tl[:, -1].argmax(-1)[:, None].numpy())
    jt, _ = jlm_generate(jp, jc, jnp.asarray(first), jnp.asarray(s, jnp.int32),
                         num_tokens=gen, cfg=jcfg)
    tt, _ = tlm_generate(tp, tc, torch.from_numpy(first), s, gen, cfg)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _paged_setup(rng, cfg, b, max_pages, ps):
    n_pages = b * max_pages + 1
    ids = rng.permutation(np.arange(1, n_pages)).reshape(b, max_pages)
    shape = (n_pages, ps, cfg.kv_heads, cfg.head_dim_())
    pools = [rng.normal(size=shape).astype(np.float32) for _ in range(2 * cfg.n_layers)]
    jc = [{"k": jnp.asarray(pools[2 * i]), "v": jnp.asarray(pools[2 * i + 1])}
          for i in range(cfg.n_layers)]
    tc = [{"k": torch.from_numpy(pools[2 * i].copy()),
           "v": torch.from_numpy(pools[2 * i + 1].copy())}
          for i in range(cfg.n_layers)]
    return ids.astype(np.int32), jc, tc


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_paged_prefill_tail_and_decode_match_reference(kind):
    """Paged prefill of a prompt, a prefix-hit tail prefill at
    start_pos = 2 pages over the first row's pages, and ragged paged
    decode steps — logits and every pool write against JAX."""
    jcfg, cfg, params = _models()
    jp, tp = params[kind]
    rng = np.random.default_rng(2)
    b, ps, max_pages, s = 2, 4, 6, 13
    tbl, jc, tc = _paged_setup(rng, cfg, b, max_pages, ps)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "page_tables": jnp.asarray(tbl)}
    tb = {"tokens": torch.from_numpy(tokens), "page_tables": torch.from_numpy(tbl)}
    jl, jc = jlm_prefill(jp, jc, jb, cfg=jcfg)
    tl, tc = tlm_prefill(tp, tc, tb, cfg)
    _close(tl, jl)

    # tail-only prefill of row 0's prompt from position 8: attends over the
    # first two pages written above and must reproduce rows [8:] of it
    start = 2 * ps
    jtail = {"tokens": jnp.asarray(tokens[:1, start:]),
             "page_tables": jnp.asarray(tbl[:1])}
    ttail = {"tokens": torch.from_numpy(tokens[:1, start:]),
             "page_tables": torch.from_numpy(tbl[:1])}
    jl2, jc = jlm_prefill(jp, jc, jtail, cfg=jcfg, start_pos=start)
    tl2, tc = tlm_prefill(tp, tc, ttail, cfg, start_pos=start)
    _close(tl2, jl2)
    _close(tl2, jl[:1, start:])

    clen = np.array([s, s - 2], np.int32)      # row 1 rewinds: ragged
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for _ in range(3):
        jd, jc = jlm_decode(jp, jc, {"tokens": jnp.asarray(tok),
                                     "page_tables": jnp.asarray(tbl)},
                            jnp.asarray(clen), cfg=jcfg)
        td, tc = tlm_decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                    "page_tables": torch.from_numpy(tbl)},
                           torch.from_numpy(clen), cfg)
        _close(td, jd)
        tok = np.asarray(jnp.argmax(jd[:, -1], -1))[:, None].astype(np.int32)
        assert np.array_equal(tok[:, 0], td[:, -1].argmax(-1).numpy())
        clen = clen + 1
    for c_t, c_j in zip(tc, jc):
        _close(c_t["k"], c_j["k"])
        _close(c_t["v"], c_j["v"])


def test_paged_attention_rejects_windows_like_reference():
    _, cfg, params = _models()
    lp = params["dense"][1]["layers"][0]["attn"]
    x = torch.zeros((1, 1, cfg.d_model))
    pool = {"k": torch.zeros((3, 4, cfg.kv_heads, 32)),
            "v": torch.zeros((3, 4, cfg.kv_heads, 32))}
    kw = dict(num_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=32,
              window=8, page_table=torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        attention_decode(lp, x, pool, torch.zeros(1, dtype=torch.int32), **kw)
    with pytest.raises(NotImplementedError):
        attention_prefill(lp, x, pool, **kw)
