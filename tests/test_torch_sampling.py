"""The port's PRNG and token selection against ``jax.random`` and the JAX
package's sampling, on the CPU.

``repro_torch.prng`` is a hand port of threefry-2x32: keys, splits and
bits must be bit-identical to ``jax.random`` for any seed and shape;
the Gumbel noise within rtol 1e-6 of max(1, |noise|) (two ``log``s in
float32 on two libraries).  ``_nucleus_filter``, the top-k filter and
``_select_token_rows`` must keep exactly the reference's token sets
(decided by position after a stable sort, so tie plateaus are cut the
same way), greedy rows must keep their keys, and the sampled
``lm_generate`` on bridged params must emit the reference's tokens.
Where the two disagree on a token, the test requires that the top two
perturbed logits there lie within 1e-5 of each other (a float32 near
tie that the two libraries' rounding may break either way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import lm_generate as jlm_generate
from repro.models import lm_prefill as jlm_prefill
from repro.models import transformer as jt
from repro_torch import prng
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.models import init_caches, lm_decode, lm_generate, lm_prefill
from repro_torch.models import transformer as tt

# float32 logs on two libraries: the noise agrees to a few ulps, relative
# to max(1, |noise|) since the noise crosses zero (at u = 1/e)
GUMBEL_RTOL = 1e-6
# two perturbed logits closer than this are a near tie either side may break
TIE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the PRNG
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=-2**31, max_value=2**40),
       st.integers(min_value=0, max_value=2**32 - 1))
def test_prngkey_and_fold_in_bit_identical(seed, data):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _np(_jkey(seed)))
    np.testing.assert_array_equal(prng.fold_in(key, data).numpy(),
                                  _np(jax.random.fold_in(_jkey(seed), data)))


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=2, max_value=5))
def test_split_bit_identical_single_and_batched(seed, num):
    key = prng.fold_in(prng.PRNGKey(seed), 7)
    jkey = jax.random.fold_in(_jkey(seed), 7)
    np.testing.assert_array_equal(prng.split(key, num).numpy(),
                                  _np(jax.random.split(jkey, num)))
    # a (B, 2) batch splits each row as that key alone would
    keys = prng.fold_in(prng.PRNGKey(seed), torch.arange(3))
    want = np.stack([_np(jax.random.split(jax.random.fold_in(_jkey(seed), r),
                                          num)) for r in range(3)])
    np.testing.assert_array_equal(prng.split(keys, num).numpy(), want)


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.sampled_from([(1,), (7,), (3, 5), (2, 3, 4), (1000,)]))
def test_bits_and_uniform_bit_identical(seed, shape):
    key, jkey = prng.PRNGKey(seed), _jkey(seed)
    np.testing.assert_array_equal(prng.bits(key, shape).numpy(),
                                  _np(jax.random.bits(jkey, shape)))
    np.testing.assert_array_equal(prng.uniform(key, shape).numpy(),
                                  _np(jax.random.uniform(jkey, shape)))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(key, shape, tiny, 1.0).numpy(),
        _np(jax.random.uniform(jkey, shape, minval=tiny, maxval=1.0)))


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_gumbel_noise_matches(seed):
    key, jkey = prng.PRNGKey(seed), _jkey(seed)
    got = prng.gumbel(key, (4, 500)).numpy()
    want = _np(jax.random.gumbel(jkey, (4, 500)))
    np.testing.assert_allclose(got, want, rtol=GUMBEL_RTOL, atol=GUMBEL_RTOL)


def test_keys_pack_through_int32_words():
    keys = prng.fold_in(prng.PRNGKey(3), torch.arange(6))
    words = prng.to_uint32_words(keys)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), keys.numpy())
    assert torch.equal(prng.from_uint32_words(words), keys)


# ---------------------------------------------------------------------------
# keep sets and per-row selection
# ---------------------------------------------------------------------------

def _logits(seed, b=6, v=64):
    rng = np.random.default_rng(seed)
    lg = rng.normal(size=(b, v)).astype(np.float32)
    lg[:, 10:20] = lg[:, 10:11]           # a tie plateau across 10 ids
    lg[0] = 0.5                           # a row that is all one plateau
    lg[1, 30:34] = lg[1].max() + 1.0      # a tie at the top
    return lg


@pytest.mark.parametrize("top_p", [0.05, 0.3, 0.5, 0.9, 0.99])
def test_nucleus_keep_set_identical(top_p):
    lg = _logits(0)
    got = tt._nucleus_filter(torch.tensor(lg), top_p).numpy()
    want = _np(jt._nucleus_filter(jnp.asarray(lg), top_p))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


@pytest.mark.parametrize("top_k", [1, 3, 12, 15, 63])
def test_top_k_keep_set_identical_on_plateaus(top_k):
    lg = _logits(1)
    ranks = tt._ranks(torch.tensor(lg)).numpy()
    want = _np(jnp.argsort(jnp.argsort(-jnp.asarray(lg), axis=-1), axis=-1))
    np.testing.assert_array_equal(ranks, want)
    # through _select_token's own path: with top_p off, a tiny temperature
    # samples from exactly the kept set
    key = prng.PRNGKey(top_k)
    for t in (1.0, 0.25):
        got, gkey = tt._select_token(torch.tensor(lg), key, temperature=t,
                                     top_k=top_k, top_p=None)
        want, wkey = jt._select_token(jnp.asarray(lg), _jkey(top_k),
                                      temperature=t, top_k=top_k, top_p=None)
        np.testing.assert_array_equal(got.numpy(), _np(want))
        np.testing.assert_array_equal(gkey.numpy(), _np(wkey))


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_select_token_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    b, v = 6, 64
    lg = _logits(seed, b, v)
    keys = prng.fold_in(prng.PRNGKey(seed), torch.arange(b))
    temp = rng.choice([0.0, 0.5, 0.8, 1.3], size=b).astype(np.float32)
    topk = rng.choice([0, 1, 5, 12, v, v + 3], size=b).astype(np.int32)
    topp = rng.choice([1.0, 0.3, 0.9, 1.5], size=b).astype(np.float32)
    got, gkeys = tt._select_token_rows(torch.tensor(lg), keys,
                                       torch.tensor(temp), torch.tensor(topk),
                                       torch.tensor(topp))
    want, wkeys = jt._select_token_rows(
        jnp.asarray(lg), jnp.asarray(keys.numpy().astype(np.uint32)),
        temp, topk, topp)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(gkeys.numpy(), _np(wkeys))
    # greedy rows leave their keys untouched; sampled rows split once
    greedy = temp <= 0
    np.testing.assert_array_equal(gkeys.numpy()[greedy], keys.numpy()[greedy])
    split = prng.split(keys)[:, 0].numpy()
    np.testing.assert_array_equal(gkeys.numpy()[~greedy], split[~greedy])


def test_select_token_rows_row_equals_scalar_select():
    """A row of the batched selection is the scalar selection of that row
    alone with its own key, bit for bit (disabled filters included)."""
    lg = torch.tensor(_logits(5))
    keys = prng.fold_in(prng.PRNGKey(9), torch.arange(6))
    temp = torch.tensor([0.0, 0.7, 0.7, 1.1, 0.9, 0.6])
    topk = torch.tensor([0, 0, 4, 70, 9, 2], dtype=torch.int32)
    topp = torch.tensor([1.0, 0.8, 1.0, 1.0, 0.5, 0.95])
    got, gkeys = tt._select_token_rows(lg, keys, temp, topk, topp)
    for i in range(6):
        k = int(topk[i])
        tok, key = tt._select_token(
            lg[i:i + 1], keys[i], temperature=float(temp[i]),
            top_k=k if 0 < k < 64 else None,
            top_p=float(topp[i]) if topp[i] < 1 else None)
        assert int(tok[0]) == int(got[i])
        assert torch.equal(key, gkeys[i])


# ---------------------------------------------------------------------------
# sampled lm_generate on bridged params
# ---------------------------------------------------------------------------

_MODEL = {}


def _model():
    """Smoke qwen with its final norm scaled by 0.02, so that the random
    model's logits are soft enough for sampling to choose."""
    if not _MODEL:
        jcfg = jmake_smoke(jget_config("qwen1.5-0.5b"), n_layers=2)
        cfg = make_smoke(get_config("qwen1.5-0.5b"), n_layers=2)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        jp["final_norm"] = {"scale": jp["final_norm"]["scale"] * 0.02}
        _MODEL.update(jcfg=jcfg, cfg=cfg, jp=jp, tp=params_from_reference(jp))
    return _MODEL


def _first_gap(m, prompt, tokens_ref, pos, t, k, p, key):
    """The gap between the two largest perturbed logits the port's
    selection sees at step ``pos`` when it is fed the reference's
    tokens up to there (the key advanced ``pos`` times)."""
    cfg, tp = m["cfg"], m["tp"]
    caches = init_caches(cfg, 1, len(prompt) + len(tokens_ref), torch.float32,
                         "cpu")
    logits, caches = lm_prefill(tp, caches, {"tokens": torch.tensor(prompt[None])},
                                cfg)
    if pos == 0:                          # the prefill's argmax
        top2 = torch.topk(logits[0, -1], 2).values
        return float(top2[0] - top2[1])
    rng = key
    for i in range(pos):
        tok = torch.tensor([[int(tokens_ref[i])]], dtype=torch.int32)
        logits, caches = lm_decode(tp, caches, {"tokens": tok},
                                   torch.tensor([len(prompt) + i]), cfg)
        if i < pos - 1:
            rng = prng.split(rng)[0]
    lg = logits[:, -1].to(torch.float32) / t
    if k is not None:
        lg = torch.where(tt._ranks(lg) < k, lg, float("-inf"))
    if p is not None:
        lg = tt._nucleus_filter(lg, p)
    sub = prng.split(rng)[1]
    pert = (prng.gumbel(sub, lg.shape) + lg)[0]
    top2 = torch.topk(pert, 2).values
    return float(top2[0] - top2[1])


@pytest.mark.parametrize("t,k,p", [(0.8, None, None), (1.0, 20, None),
                                   (0.7, None, 0.9), (0.9, 50, 0.8)])
def test_sampled_lm_generate_matches_reference(t, k, p):
    m = _model()
    rng = np.random.default_rng(11)
    gen = 12
    for r in range(3):
        prompt = rng.integers(0, m["cfg"].vocab, size=int(rng.integers(4, 9)))
        prompt = prompt.astype(np.int32)
        jkey = jax.random.fold_in(jax.random.PRNGKey(5), r)
        jc = jinit_caches(m["jcfg"], 1, len(prompt) + gen, jnp.float32)
        jlg, jc = jlm_prefill(m["jp"], jc, {"tokens": jnp.asarray(prompt[None])},
                              m["jcfg"])
        jfirst = jnp.argmax(jlg[:, -1], -1)[:, None].astype(jnp.int32)
        want, _ = jlm_generate(m["jp"], jc, jfirst, len(prompt), gen, m["jcfg"],
                               temperature=t, top_k=k, top_p=p, key=jkey)
        want = _np(want)[0]
        key = prng.fold_in(prng.PRNGKey(5), r)
        tc = init_caches(m["cfg"], 1, len(prompt) + gen, torch.float32, "cpu")
        tlg, tc = lm_prefill(m["tp"], tc, {"tokens": torch.tensor(prompt[None])},
                             m["cfg"])
        tfirst = torch.argmax(tlg[:, -1], -1).to(torch.int32)[:, None]
        got, _ = lm_generate(m["tp"], tc, tfirst, len(prompt), gen, m["cfg"],
                             temperature=t, top_k=k, top_p=p, key=key)
        got = got[0].numpy()
        assert len(set(want.tolist())) > 1      # sampling really chose
        diff = np.nonzero(got != want)[0]
        if diff.size:
            pos = int(diff[0])
            gap = _first_gap(m, prompt, want, pos, t, k, p, key)
            assert gap <= TIE_ATOL, (r, pos, got, want, gap)
