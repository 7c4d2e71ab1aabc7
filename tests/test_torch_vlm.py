"""The port's multimodal path (qwen2-vl-2b: M-RoPE, patch embeddings)
against the JAX package, on the CPU.

* ``apply_mrope`` with three distinct position components (temporal,
  height, width) against the reference's, and against RoPE: with equal
  components it is RoPE, with distinct ones it is not (a wrong section
  map would pass a text-only test);
* the qwen2-vl smoke config (fp32, 4 layers, d_model 128, 4 query heads
  and 2 KV heads of 32, M-RoPE sections (4, 6, 6), QKV bias, 8 stub
  patches) initialised in JAX and carried over with
  ``repro_torch.bridge``, dense and knapsack-pruned + BSR-packed by the
  reference: ``lm_forward`` and ``lm_prefill`` with patch embeddings and
  Qwen2-VL's 3-D positions (the patches on a 2x4 grid at (0, i // 4,
  i % 4), then text at 4 + j in every component), logits within 1e-4 of
  the largest |logit| (fp32); per-token ``lm_decode`` after that prefill
  and greedy ``lm_generate`` tokens equal.  Decode resumes at position
  ``cache_len`` in all three components, as the reference's does
  (``ROADMAP.md`` §3, finding 5);
* ``ServingEngine`` text-only streams (greedy and sampled) equal the
  JAX engine's on the packed smoke model, with a prefix-cache hit in
  both.

The tied embedding is scaled by the chip smoke's ``EMBED_SCALE``, as for
the other random models.
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
from repro.models import lm_decode, lm_forward, lm_generate, lm_prefill
from repro.models.layers import apply_mrope as japply_mrope
from repro.serving import ServingEngine as JServingEngine
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.models import init_caches
from repro_torch.models import lm_decode as tlm_decode
from repro_torch.models import lm_forward as tlm_forward
from repro_torch.models import lm_generate as tlm_generate
from repro_torch.models import lm_prefill as tlm_prefill
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.serving import ServingEngine

from chip_smoke import EMBED_SCALE, distinct_enough, vlm_batch

TOL = 1e-4                 # of max(1, max |ref|), fp32
_CACHE = {}
jlm_forward = jax.jit(lm_forward, static_argnames=("cfg",))
jlm_prefill = jax.jit(lm_prefill, static_argnames=("cfg", "start_pos"))
jlm_decode = jax.jit(lm_decode, static_argnames=("cfg",))
jlm_generate = jax.jit(lm_generate, static_argnames=("num_tokens", "cfg"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
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


@pytest.mark.parametrize("sections,dh,theta", [((4, 6, 6), 32, 1e6),
                                                ((16, 24, 24), 128, 1e6),
                                                ((2, 1, 1), 8, 1e4)])
def test_apply_mrope_matches_reference_with_distinct_components(sections, dh, theta):
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(2, 5, 3, dh)).astype(np.float32)
    pos = np.stack([rng.permutation(40)[:5], rng.integers(0, 30, size=5),
                    rng.integers(100, 200, size=5)], axis=-1)
    pos = np.stack([pos, pos[::-1]]).astype(np.int32)          # (2, 5, 3)
    assert all(len(set(p)) == 3 for p in pos.reshape(-1, 3))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, theta=theta)
    want = japply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta=theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # each section really reads its own component: RoPE by any one
    # component alone gives another result
    for c in range(3):
        one = apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., c]), theta=theta)
        assert float((one - got).abs().max()) > 1e-2
    same = np.repeat(pos[..., :1], 3, axis=-1)
    np.testing.assert_allclose(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same), sections,
                    theta=theta).numpy(),
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]),
                   theta=theta).numpy(), atol=1e-6)


def test_apply_mrope_refuses_sections_that_miss_head_dim():
    with pytest.raises(ValueError, match="do not sum"):
        apply_mrope(torch.zeros((1, 1, 1, 32)), torch.zeros((1, 1, 3)), (4, 6, 5))


def _vlm(kind):
    if kind not in _CACHE:
        jcfg = jmake_smoke(jget_config("qwen2-vl-2b"))
        cfg = make_smoke(get_config("qwen2-vl-2b"))
        assert (cfg.num_patches, cfg.mrope_sections, cfg.kv_heads) == (8, (4, 6, 6), 2)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        jp = {**jp, "embed": {"embedding": jp["embed"]["embedding"] * EMBED_SCALE}}
        if kind == "packed":
            sel = jknapsack_prune(jp, sparsity=0.5, blocking=JBlockingSpec(bk=32, bn=32),
                                  min_size=1024)
            jp = jpack_params(jp, sel.masks, sel.structures)
        _CACHE[kind] = (jcfg, cfg, jp, params_from_reference(jp))
    return _CACHE[kind]


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_patch_prefill_then_decode_match_reference(kind):
    jcfg, cfg, jp, tp = _vlm(kind)
    b, text, gen = 2, 6, 8
    tokens, patches, pos = vlm_batch(cfg, b, text, seed=3, grid=(2, 4))
    s = tokens.shape[1]
    jb = {"tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches),
          "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.from_numpy(tokens), "patch_embeds": torch.from_numpy(patches),
          "positions": torch.from_numpy(pos)}
    jf = jlm_forward(jp, jb, cfg=jcfg)[0]
    tf = tlm_forward(tp, tb, cfg)[0]
    _close(tf, jf)
    # the patches and the 3-D positions move the logits past the parity
    # tolerance: a dropped patch or a wrong section map fails this test
    plain = tlm_forward(tp, {"tokens": torch.from_numpy(tokens),
                             "positions": torch.from_numpy(pos)}, cfg)[0]
    text_pos = tlm_forward(tp, {**tb, "positions": torch.from_numpy(pos[..., 0])}, cfg)[0]
    for other in (plain, text_pos):
        with pytest.raises(AssertionError):
            _close(other, jf, tol=3 * TOL)

    jc = jinit_caches(jcfg, b, s + gen, jnp.float32)
    tc = init_caches(cfg, b, s + gen, torch.float32, "cpu")
    jl, jc = jlm_prefill(jp, jc, jb, cfg=jcfg)
    tl, tc = tlm_prefill(tp, tc, tb, cfg)
    _close(tl, jl)
    _close(tl, tf)
    for c_t, c_j in zip(tc, jc):
        _close(c_t["k"], c_j["k"])

    first = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    snap = [{k: v.clone() for k, v in c.items()} for c in tc]
    jt, _ = jlm_generate(jp, jc, jnp.asarray(first.numpy()), jnp.asarray(s, jnp.int32),
                         num_tokens=gen, cfg=jcfg)
    tt, _ = tlm_generate(tp, tc, first, s, gen, cfg)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert len(set(tt.flatten().tolist())) >= 4          # not one repeated token
    tok, caches = first, snap
    for i in range(gen):
        assert np.array_equal(tok[:, 0].numpy(), tt[:, i].numpy())
        td, caches = tlm_decode(tp, caches, {"tokens": tok}, s + i, cfg)
        tok = td[:, -1].argmax(-1).to(torch.int32)[:, None]


def test_text_prefill_tiles_positions_like_reference():
    """Without positions a M-RoPE prefill takes [start, start + S) in all
    three components, decode ``cache_len``: both equal plain RoPE on a
    text-only prompt."""
    jcfg, cfg, jp, tp = _vlm("dense")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 9)).astype(np.int32)
    jl = jlm_prefill(jp, jinit_caches(jcfg, 2, 12, jnp.float32),
                     {"tokens": jnp.asarray(tokens)}, cfg=jcfg)[0]
    tl = tlm_prefill(tp, init_caches(cfg, 2, 12, torch.float32, "cpu"),
                     {"tokens": torch.from_numpy(tokens)}, cfg)[0]
    _close(tl, jl)
    rope = cfg.replace(mrope_sections=None)
    _close(tlm_prefill(tp, init_caches(rope, 2, 12, torch.float32, "cpu"),
                       {"tokens": torch.from_numpy(tokens)}, rope)[0], jl)


def test_engine_text_streams_match_reference_engine():
    """Requests 0 and 1 share a prompt (a prefix-cache hit) and decode
    greedily; 2 and 3 sample (temperature 1.0, the port's threefry is
    bit-identical to ``jax.random``), so that the compared streams are
    not one repeated token."""
    jcfg, cfg, jp, tp = _vlm("packed")
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab, size=8)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, size=n)]).astype(np.int32)
               for n in (3, 6, 1, 5)]
    prompts[1] = prompts[0].copy()
    gens, arrivals, temps = [6, 5, 8, 8], [0, 2, 2, 5], [0.0, 0.0, 1.0, 1.0]
    kw = dict(num_slots=2, page_size=4, max_seq_len=24, ticks_per_sync=3, seed=3)
    runs = {}
    for name, eng in (("jax", JServingEngine(jp, jcfg, **kw)),
                      ("torch", ServingEngine(tp, cfg, device="cpu", **kw))):
        for p, g, a, t in zip(prompts, gens, arrivals, temps):
            eng.submit(p, g, arrival=a, temperature=t)
        done = eng.run()
        runs[name] = ([done[i].tokens.tolist() for i in range(4)],
                      [done[i].admitted_at for i in range(4)],
                      eng.prefix_stats["hit_requests"])
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][2] >= 1
    streams = runs["torch"][0]
    assert [len(t) for t in streams] == gens
    assert all(distinct_enough(t) for t in streams[2:])


def test_decode_after_patch_prefill_resumes_at_cache_len_in_both():
    """A finding in the reference (``ROADMAP.md`` §3, finding 5), which
    the port keeps: after a patch prefill whose text ends at position
    max(rows, cols) + text - 1, ``lm_decode`` rotates the next token at
    ``cache_len`` = P + text in all three components (reference
    ``attention.py:407-410``), not at the next text position Qwen2-VL's
    layout gives it.  Smallest input: the smoke model, 8 patches on a
    2x4 grid and 1 text token (positions up to 4): the decoded token sits
    at 9, where the layout says 5.  Both packages' decode logits equal a
    whole-sequence forward with the token at (9, 9, 9), not at (5, 5, 5)."""
    jcfg, cfg, jp, tp = _vlm("dense")
    tokens, patches, pos = vlm_batch(cfg, 1, 1, seed=9, grid=(2, 4))
    s = tokens.shape[1]
    nxt = np.array([[17]], np.int32)
    tb = {"tokens": torch.from_numpy(tokens), "patch_embeds": torch.from_numpy(patches),
          "positions": torch.from_numpy(pos)}
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    caches = init_caches(cfg, 1, s + 1, torch.float32, "cpu")
    _, caches = tlm_prefill(tp, caches, tb, cfg)
    td, _ = tlm_decode(tp, caches, {"tokens": torch.from_numpy(nxt)}, s, cfg)
    jc = jlm_prefill(jp, jinit_caches(jcfg, 1, s + 1, jnp.float32), jb, cfg=jcfg)[1]
    jd, _ = jlm_decode(jp, jc, {"tokens": jnp.asarray(nxt)}, jnp.asarray(s, jnp.int32),
                       cfg=jcfg)
    _close(td, jd)

    def forward_at(p):
        full = {"tokens": torch.from_numpy(np.concatenate([tokens, nxt], 1)),
                "patch_embeds": tb["patch_embeds"],
                "positions": torch.from_numpy(np.concatenate(
                    [pos, np.full((1, 1, 3), p, np.int32)], 1))}
        return tlm_forward(tp, full, cfg)[0][:, -1:]

    assert int(pos.max()) + 1 == 5 and s == 9
    _close(td, forward_at(s))
    with pytest.raises(AssertionError):
        _close(td, forward_at(5), tol=10 * TOL)
