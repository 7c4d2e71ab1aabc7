"""The port's recurrent and hybrid modules against the JAX package, on the CPU.

Same seeded numpy inputs, and JAX-initialised params carried over with
``repro_torch.bridge``, go through the JAX function and its counterpart
in the port:

* ``layernorm`` in fp32 and bf16;
* Mamba (``mamba_apply`` / ``mamba_prefill`` / ``mamba_decode``), mLSTM
  and sLSTM, each from a random carried state, at one chunk, at ragged
  chunks and past the reference's ``CHUNK_UNROLL_LIMIT`` (where it runs
  ``lax.scan``);
* prefill of S then one decode step against prefill of S + 1 (the
  carried conv, SSM, (C, n, m) and sLSTM states);
* the jamba and xLSTM smoke models at 8 layers, so that jamba has its
  attention layer (index 4 of the period) and xLSTM its sLSTM layer
  (index 7): the param and cache trees, ``lm_prefill`` / ``lm_forward``
  logits and greedy ``lm_generate`` tokens, dense and (jamba) packed.

Tolerances: fp32 results of one layer within 1e-5 (relative to max(1,
max |ref|)); the 8-layer models' logits within 1e-4, as the attention
models' are in ``tests/test_torch_moe.py``: the layers compound their
ulps, and both sides' CPU reductions may split across threads.
The port's Mamba scan is a log-depth doubling scan where the reference
takes ``lax.associative_scan``: the same combine, summed in another
order, so the two agree to a few ulps, not bit for bit.  bf16 results
within 1e-2 (one bf16 rounding).  Greedy tokens are equal.
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
from repro.models import lm_forward as jlm_forward
from repro.models import lm_generate as jlm_generate
from repro.models import lm_prefill as jlm_prefill
from repro.models import mamba as jmamba
from repro.models import xlstm as jxlstm
from repro.models.layers import layernorm as jlayernorm
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference, tensor_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.core.structures import iter_leaves
from repro_torch.models import init_caches, init_params, lm_forward, lm_generate, lm_prefill
from repro_torch.models import mamba, xlstm
from repro_torch.models.layers import layernorm
from repro_torch.models.transformer import _check_ported

from chip_smoke import EMBED_SCALE, MIN_DISTINCT_SHARE, distinct_enough

TOL = 1e-5
MODEL_TOL = 1e-4
D, H = 128, 4
_CACHE = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke-size ops are far too small for intra-op threads: with one
    per test worker they do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    assert err <= tol, err


def _tree_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], tol)


# ---------------------------------------------------------------------------
# layernorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 1e-2)])
def test_layernorm_matches_reference(dtype, tol):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(2.0, 3.0, size=(3, 5, D)).astype(np.float32)).astype(dtype)
    p = {"scale": jnp.asarray(rng.normal(size=D).astype(np.float32)).astype(dtype),
         "bias_vec": jnp.asarray(rng.normal(size=D).astype(np.float32)).astype(dtype)}
    got = layernorm(params_from_reference(p), tensor_from_reference(x))
    assert got.dtype == tensor_from_reference(x).dtype
    _close(got, np.asarray(jlayernorm(p, x).astype(jnp.float32)), tol)


# ---------------------------------------------------------------------------
# the recurrent mixers, one layer
# ---------------------------------------------------------------------------

def _mixer(kind):
    """(JAX params, port params, random carried state as numpy) of one
    mixer at d_model 128, 4 heads, d_state 8."""
    key = ("mixer", kind)
    if key not in _CACHE:
        k = jax.random.PRNGKey(3)
        rng = np.random.default_rng(7)
        if kind == "mamba":
            jp = jmamba.mamba_init(k, D, d_state=8)
            state = {"conv": rng.normal(size=(2, 3, 2 * D)),
                     "ssm": rng.normal(size=(2, 2 * D, 8))}
        elif kind == "mlstm":
            jp = jxlstm.mlstm_init(k, D, H)
            dh = 2 * D // H
            state = {"C": rng.normal(size=(2, H, dh, dh)),
                     "n": rng.normal(size=(2, H, dh)),
                     "m": rng.normal(size=(2, H))}
        else:
            jp = jxlstm.slstm_init(k, D, H)
            state = {"c": rng.normal(size=(2, D)),
                     "n": rng.uniform(0.5, 2.0, size=(2, D)),
                     "h": rng.normal(size=(2, D)),
                     "m": rng.normal(size=(2, D))}
        state = {n: v.astype(np.float32) for n, v in state.items()}
        _CACHE[key] = (jp, params_from_reference(jp), state)
    return _CACHE[key]


_STATIC = ("chunk", "num_heads")
JFNS = {
    "mamba": (jax.jit(jmamba.mamba_apply, static_argnames=("chunk",)),
              jax.jit(jmamba.mamba_prefill, static_argnames=("chunk",)),
              jax.jit(jmamba.mamba_decode)),
    "mlstm": (jax.jit(jxlstm.mlstm_apply, static_argnames=_STATIC),
              jax.jit(jxlstm.mlstm_prefill, static_argnames=_STATIC),
              jax.jit(jxlstm.mlstm_decode, static_argnames=("num_heads",))),
    "slstm": (jax.jit(jxlstm.slstm_apply, static_argnames=("num_heads",)),
              jax.jit(jxlstm.slstm_prefill, static_argnames=("num_heads",)),
              jax.jit(jxlstm.slstm_decode, static_argnames=("num_heads",))),
}
TFNS = {
    "mamba": (mamba.mamba_apply, mamba.mamba_prefill, mamba.mamba_decode),
    "mlstm": (xlstm.mlstm_apply, xlstm.mlstm_prefill, xlstm.mlstm_decode),
    "slstm": (xlstm.slstm_apply, xlstm.slstm_prefill, xlstm.slstm_decode),
}


def _kw(kind, s=None):
    kw = {} if kind == "mamba" else {"num_heads": H}
    if s is not None and kind != "slstm":
        kw["chunk"] = 16          # the smoke configs' ssm_chunk
    return kw


def _x(s, seed=11):
    return np.random.default_rng(seed).normal(size=(2, s, D)).astype(np.float32)


# S 7: one partial chunk; 37: ragged chunks (the reference's Python
# loop); 80: five full chunks (the reference's lax.scan)
@pytest.mark.parametrize("s", [7, 37, 80])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_apply_and_prefill_match_reference(kind, s):
    jp, tp, state = _mixer(kind)
    x = _x(s)
    japply, jprefill, _ = JFNS[kind]
    tapply, tprefill, _ = TFNS[kind]
    with torch.no_grad():
        _close(tapply(tp, torch.from_numpy(x), **_kw(kind, s)),
               japply(jp, jnp.asarray(x), **_kw(kind, s)))
        cache = {n: torch.from_numpy(v.copy()) for n, v in state.items()}
        got, cache2 = tprefill(tp, torch.from_numpy(x), cache, **_kw(kind, s))
    want, jcache = jprefill(jp, jnp.asarray(x), {n: jnp.asarray(v) for n, v in state.items()},
                            **_kw(kind, s))
    _close(got, want)
    assert cache2 is cache                      # the state went in place
    _tree_close(cache, jcache)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_decode_matches_reference(kind):
    jp, tp, state = _mixer(kind)
    x = _x(1, seed=12)
    with torch.no_grad():
        cache = {n: torch.from_numpy(v.copy()) for n, v in state.items()}
        got, _ = TFNS[kind][2](tp, torch.from_numpy(x), cache, **_kw(kind))
    want, jcache = JFNS[kind][2](jp, jnp.asarray(x),
                                 {n: jnp.asarray(v) for n, v in state.items()},
                                 **_kw(kind))
    _close(got, want)
    _tree_close(cache, jcache)


@pytest.mark.parametrize("s", [5, 20])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_prefill_then_decode_equals_longer_prefill(kind, s):
    """Prefill of S then one decode step from the carried state gives
    the last output and the final state of a prefill of S + 1."""
    _, tp, state = _mixer(kind)
    x = _x(s + 1, seed=13)
    fresh = lambda: {n: torch.from_numpy(v.copy()) for n, v in state.items()}
    _, prefill, decode = TFNS[kind]
    with torch.no_grad():
        whole, c_whole = prefill(tp, torch.from_numpy(x), fresh(), **_kw(kind, s))
        c_step = fresh()
        prefill(tp, torch.from_numpy(x[:, :s]), c_step, **_kw(kind, s))
        last, _ = decode(tp, torch.from_numpy(x[:, s:]), c_step, **_kw(kind))
    _close(last, whole[:, s:].numpy())
    _tree_close(c_step, {n: t.numpy() for n, t in c_whole.items()})


def test_slstm_post_mlp_gelu_is_the_tanh_approximation():
    """jax.nn.gelu's default is the tanh form; the exact erf form moves
    the sLSTM block's output by more than the tolerance."""
    jp, tp, state = _mixer("slstm")
    x = _x(6, seed=14)
    want = np.asarray(JFNS["slstm"][0](jp, jnp.asarray(x), num_heads=H))
    with torch.no_grad():
        _close(xlstm.slstm_apply(tp, torch.from_numpy(x), num_heads=H), want)
        hs = torch.randn(2, 6, D, generator=torch.Generator().manual_seed(0))
        tanh = xlstm._slstm_mlp(tp, torch.from_numpy(x), hs)
        up = torch.matmul(hs, tp["up"]["kernel"])
        erf = torch.matmul(torch.nn.functional.gelu(up), tp["down"]["kernel"])
    assert float((tanh - erf).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the smoke models at 8 layers
# ---------------------------------------------------------------------------

ARCHS = ["jamba-v0.1-52b", "xlstm-350m"]


def _model(arch, packed=False):
    """(jax cfg, torch cfg, jax params, torch params) of the 8-layer
    smoke model; packed: knapsack 0.5 at 32x32 tiles (jamba).  The tied
    embedding is scaled by the chip smoke's ``EMBED_SCALE``, so that
    greedy tokens follow the layers' state (at its init scale every
    stream repeats the prompt's last token)."""
    key = ("model", arch, packed)
    if key not in _CACHE:
        jcfg = jmake_smoke(jget_config(arch), n_layers=8)
        cfg = make_smoke(get_config(arch), n_layers=8)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        jp = {**jp, "embed": {"embedding": jp["embed"]["embedding"] * EMBED_SCALE}}
        if packed:
            sel = jknapsack_prune(jp, sparsity=0.5, blocking=JBlockingSpec(bk=32, bn=32),
                                  min_size=1024)
            jp = jpack_params(jp, sel.masks, sel.structures)
        _CACHE[key] = (jcfg, cfg, jp, params_from_reference(jp))
    return _CACHE[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_at_8_layers_has_every_layer_kind(arch):
    cfg = make_smoke(get_config(arch), n_layers=8)
    jcfg = jmake_smoke(jget_config(arch), n_layers=8)
    for f in ("mixer_pattern", "mlp_pattern", "d_state", "d_conv", "ssm_chunk",
              "mlstm_proj_factor", "norm_type", "n_layers", "d_model", "vocab"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    mixers = {s.mixer for s in _check_ported(cfg)}
    assert mixers == ({"mamba", "attn"} if arch.startswith("jamba")
                      else {"mlstm", "slstm"})


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_match_reference(arch):
    """The port's own init gives the reference's leaves (paths, shapes,
    dtypes; other numbers), and the bridge carries every leaf over,
    among them conv_kernel, conv_bias_vec, a_log, d_skip, dt_proj's bias,
    wif's bias, r_rec and layernorm's scale and bias_vec."""
    jcfg, cfg, jp, tp = _model(arch)
    want = {p: (tuple(a.shape), str(a.dtype)) for p, a in iter_leaves(jp)}
    mine = init_params(cfg, seed=0, device="cpu")
    for tree in (tp, mine):
        got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for p, t in iter_leaves(tree)}
        assert got == want
    names = {p.split("/", 2)[-1] for p in want}
    expect = ({"mamba/conv_kernel", "mamba/conv_bias_vec", "mamba/a_log",
               "mamba/d_skip", "mamba/dt_proj/bias"} if arch.startswith("jamba")
              else {"mlstm/wif/bias", "slstm/r_rec", "pre_norm/bias_vec"})
    assert expect <= names
    jc = jinit_caches(jcfg, 3, 10, jnp.float32)
    tc = init_caches(cfg, 3, 10, torch.float32, device="cpu")
    assert len(tc) == len(jc)
    for got, w in zip(tc, jc):
        assert sorted(got) == sorted(w)
        for k in w:
            assert tuple(got[k].shape) == w[k].shape
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("arch,packed", [("jamba-v0.1-52b", False),
                                         ("jamba-v0.1-52b", True),
                                         ("xlstm-350m", False)])
def test_model_prefill_and_generate_match_reference(arch, packed):
    jcfg, cfg, jp, tp = _model(arch, packed)
    rng = np.random.default_rng(5)
    s, gen = 21, 6
    toks = rng.integers(0, cfg.vocab, size=(2, s)).astype(np.int32)
    jc = jinit_caches(jcfg, 2, s + gen, jnp.float32)
    jl, jc = jax.jit(jlm_prefill, static_argnames=("cfg",))(
        jp, jc, {"tokens": jnp.asarray(toks)}, cfg=jcfg)
    tc = init_caches(cfg, 2, s + gen, torch.float32, device="cpu")
    with torch.no_grad():
        tl, _ = lm_prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, cfg)
        fwd, aux = lm_forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(tl, jl, MODEL_TOL)
    jfwd, jaux = jax.jit(jlm_forward, static_argnames=("cfg",))(
        jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg)
    _close(fwd, jfwd, MODEL_TOL)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]),
                               rtol=1e-5, atol=1e-6)
    first = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    want, _ = jax.jit(jlm_generate, static_argnames=("num_tokens", "cfg"))(
        jp, jc, jnp.asarray(first), jnp.int32(s), num_tokens=gen, cfg=jcfg)
    got, _ = lm_generate(tp, tc, torch.from_numpy(first), s, gen, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the chip smoke's floor: at least half of each stream's tokens distinct
    assert all(distinct_enough(row) for row in got.tolist()), MIN_DISTINCT_SHARE


def test_start_pos_prefill_rejects_recurrent_stacks():
    _, cfg, _, tp = _model("jamba-v0.1-52b")
    tc = init_caches(cfg, 1, 8, torch.float32, device="cpu")
    table = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        lm_prefill(tp, tc, {"tokens": torch.zeros((1, 4), dtype=torch.int32),
                            "page_tables": table}, cfg, start_pos=4)
