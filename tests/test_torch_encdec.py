"""The port's encoder-decoder stack (whisper-tiny) against the JAX package,
on the CPU.

The whisper-tiny smoke config (fp32, 2 encoder + 4 decoder layers,
d_model 128, 4 heads of 32, 16 frames, layernorm, non-gated gelu MLP,
no RoPE) is initialised in JAX and carried over with
``repro_torch.bridge`` (the encoder tree and each decoder layer's
``cross`` / ``cross_norm`` included), dense and knapsack-pruned +
BSR-packed by the reference (the cross projections stay dense there:
``"cross"`` matches none of the pruner's include substrings).  Frames
and tokens are numpy draws from a seed.  The decoder has no positional
signal (``use_rope=False`` and no learned positions, as in the
reference), so greedy streams of random weights settle on one token
(scaling the tied embedding, as the other random models' tests do, does
not change that); the decode is therefore also run teacher-forced.

* ``sinusoidal_positions`` equals the reference's;
* ``encoder_forward``, ``encode_kv_caches``, ``lm_forward`` with frames,
  ``lm_prefill`` and per-token ``lm_decode`` logits within 1e-4 of the
  largest |logit| (fp32; the layers compound their ulps), greedy
  ``lm_generate`` tokens equal, the prefill + generate tokens equal to
  per-token decode, teacher-forced decode logits equal to
  ``lm_forward``'s over the whole sequence, and a row decoded alone
  equal to the same row in a batch;
* the config's own dtypes (fp32 params, bf16 activations) within 1e-2;
* the launcher's fixed-batch path on the CPU (``--pruned 0.75``);
* the refusals: the engine refuses whisper (and mixtral's window) with
  the reference's messages, a prefix-hit tail prefill and a paged cross
  read are refused.
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
from repro.models.layers import sinusoidal_positions as jsinusoidal_positions
from repro.models.transformer import encode_kv_caches as jencode_kv_caches
from repro.models.transformer import encoder_forward as jencoder_forward
from repro.serving import ServingEngine as JServingEngine
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.core import BSRWeight
from repro_torch.core.structures import iter_leaves
from repro_torch.launch import serve
from repro_torch.models import (encode_kv_caches, encoder_forward, init_caches,
                                init_params, lm_decode as tlm_decode,
                                lm_forward as tlm_forward,
                                lm_generate as tlm_generate,
                                lm_prefill as tlm_prefill)
from repro_torch.models.attention import attention_decode
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.serving import ServingEngine


TOL = 1e-4                 # of max(1, max |ref|), fp32
_CACHE = {}
jlm_forward = jax.jit(lm_forward, static_argnames=("cfg",))
jlm_prefill = jax.jit(lm_prefill, static_argnames=("cfg", "start_pos"))
jlm_decode = jax.jit(lm_decode, static_argnames=("cfg",))
jlm_generate = jax.jit(lm_generate, static_argnames=("num_tokens", "cfg"))
jencode = jax.jit(jencoder_forward, static_argnames=("cfg",))


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


def _whisper(kind):
    """(jax cfg, torch cfg, jax params, torch params) of whisper smoke."""
    if kind not in _CACHE:
        jcfg = jmake_smoke(jget_config("whisper-tiny"))
        cfg = make_smoke(get_config("whisper-tiny"))
        assert (cfg.enc_layers, cfg.enc_frames, cfg.n_layers) == (2, 16, 4)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        if kind == "packed":
            sel = jknapsack_prune(jp, sparsity=0.5, blocking=JBlockingSpec(bk=32, bn=32),
                                  min_size=1024)
            jp = jpack_params(jp, sel.masks, sel.structures)
        _CACHE[kind] = (jcfg, cfg, jp, params_from_reference(jp))
    return _CACHE[kind]


def _inputs(cfg, b=2, s=7, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    return frames, tokens


@pytest.mark.parametrize("length,dim", [(16, 128), (1500, 384), (7, 10)])
def test_sinusoidal_positions_match_reference(length, dim):
    got = sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsinusoidal_positions(length, dim)))


def test_bridge_carries_the_encoder_and_cross_trees():
    _, cfg, jp, tp = _whisper("dense")
    paths = {p for p, _ in iter_leaves(tp)}
    assert {"encoder/layers/1/attn/wq/kernel", "encoder/final_norm/bias_vec",
            "layers/3/cross/wk/kernel", "layers/0/cross_norm/scale"} <= paths
    ours = init_params(cfg, device="cpu")
    assert {p: tuple(t.shape) for p, t in iter_leaves(ours)} == {
        p: tuple(t.shape) for p, t in iter_leaves(tp)}
    _, _, _, packed = _whisper("packed")
    kinds = {p: isinstance(t, BSRWeight) for p, t in iter_leaves(packed)}
    assert kinds["encoder/layers/0/mlp/w_up/kernel"]
    assert not any(v for p, v in kinds.items() if "/cross/" in p)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_encoder_and_cross_kv_match_reference(kind):
    jcfg, cfg, jp, tp = _whisper(kind)
    frames, _ = _inputs(cfg)
    je = jencode(jp, jnp.asarray(frames), cfg=jcfg)
    te = encoder_forward(tp, torch.from_numpy(frames), cfg)
    _close(te, je)
    jc = jencode_kv_caches(jp, je, jcfg, jinit_caches(jcfg, 2, 12, jnp.float32))
    tc = encode_kv_caches(tp, te, cfg, init_caches(cfg, 2, 12, torch.float32, "cpu"))
    for c_t, c_j in zip(tc, jc):
        assert tuple(c_t["cross_k"].shape) == (2, cfg.enc_frames, cfg.kv_heads, 32)
        _close(c_t["cross_k"], c_j["cross_k"])
        _close(c_t["cross_v"], c_j["cross_v"])


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_whisper_forward_prefill_decode_generate_match_reference(kind):
    """Forward with frames, prefill, greedy generate and per-token decode
    against JAX.  Greedy streams of these random weights settle on one
    token (the decoder has no positional signal, as in the reference), so
    the per-token decode is also run teacher-forced on seeded tokens and
    held against ``lm_forward`` over the whole sequence."""
    jcfg, cfg, jp, tp = _whisper(kind)
    frames, tokens = _inputs(cfg)
    b, s, gen = 2, 7, 8
    forced = np.random.default_rng(1).integers(0, cfg.vocab, size=(b, gen)).astype(np.int32)
    full = np.concatenate([tokens, forced], axis=1)
    jf = jlm_forward(jp, {"tokens": jnp.asarray(full), "frames": jnp.asarray(frames)},
                     cfg=jcfg)[0]
    tf = tlm_forward(tp, {"tokens": torch.from_numpy(full),
                          "frames": torch.from_numpy(frames)}, cfg)[0]
    _close(tf, jf)

    je = jencode(jp, jnp.asarray(frames), cfg=jcfg)
    jc = jencode_kv_caches(jp, je, jcfg, jinit_caches(jcfg, b, s + gen, jnp.float32))
    tc = init_caches(cfg, b, s + gen, torch.float32, "cpu")
    tc = encode_kv_caches(tp, encoder_forward(tp, torch.from_numpy(frames), cfg), cfg, tc)
    jl, jc = jlm_prefill(jp, jc, {"tokens": jnp.asarray(tokens)}, cfg=jcfg)
    tl, tc = tlm_prefill(tp, tc, {"tokens": torch.from_numpy(tokens)}, cfg)
    _close(tl, jl)
    _close(tl, tf[:, :s])                  # prefill == forward with frames

    first = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    assert np.array_equal(first.numpy(), np.asarray(jnp.argmax(jl[:, -1], -1))[:, None])
    snap = [{k: v.clone() for k, v in c.items()} for c in tc]
    forced_caches = [{k: v.clone() for k, v in c.items()} for c in tc]
    jt, _ = jlm_generate(jp, jc, jnp.asarray(first.numpy()), jnp.asarray(s, jnp.int32),
                         num_tokens=gen, cfg=jcfg)
    tt, _ = tlm_generate(tp, tc, first, s, gen, cfg)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

    # per-token greedy lm_decode on the prefilled caches: logits vs JAX,
    # tokens vs lm_generate's
    tok, caches, jcs = first, snap, jc
    for i in range(gen):
        assert np.array_equal(tok[:, 0].numpy(), tt[:, i].numpy())
        td, caches = tlm_decode(tp, caches, {"tokens": tok}, s + i, cfg)
        jd, jcs = jlm_decode(jp, jcs, {"tokens": jnp.asarray(tok.numpy())},
                             jnp.asarray(s + i, jnp.int32), cfg=jcfg)
        _close(td, jd)
        tok = td[:, -1].argmax(-1).to(torch.int32)[:, None]
    # teacher-forced decode: step i's logits are lm_forward's at s + i
    caches = forced_caches
    for i in range(gen - 1):
        td, caches = tlm_decode(tp, caches, {"tokens": torch.from_numpy(forced[:, i:i + 1])},
                                s + i, cfg)
        _close(td[:, 0], tf[:, s + i])


def test_whisper_rows_decode_alone_as_in_the_batch():
    _, cfg, _, tp = _whisper("packed")
    frames, tokens = _inputs(cfg, b=3, seed=4)

    def run(rows):
        c = init_caches(cfg, len(rows), 7 + 6, torch.float32, "cpu")
        c = encode_kv_caches(tp, encoder_forward(
            tp, torch.from_numpy(frames[rows]), cfg), cfg, c)
        logits, c = tlm_prefill(tp, c, {"tokens": torch.from_numpy(tokens[rows])}, cfg)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return tlm_generate(tp, c, first, 7, 6, cfg)[0]

    batch = run([0, 1, 2])
    for r in range(3):
        np.testing.assert_array_equal(run([r]).numpy(), batch[r:r + 1].numpy())


def test_launcher_serves_whisper_on_the_cpu(capsys):
    assert serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu",
                       "--pruned", "0.75", "--gen", "6"]) == 0
    out = capsys.readouterr().out
    assert "pruned: kept" in out and "generated (4, 6) tokens on cpu" in out
    cfg = make_smoke(get_config("whisper-tiny"))
    prompt, frames = serve.static_inputs(cfg, batch=4, prompt_len=16, seed=0,
                                         device="cpu")
    assert tuple(frames.shape) == (4, 16, 128) and frames.dtype == torch.float32
    assert tuple(prompt.shape) == (4, 16)


@pytest.mark.parametrize("arch,message", [
    ("whisper-tiny", "encoder-decoder archs are not paged-servable"),
    ("mixtral-8x7b", "paged KV caches do not support SWA windows")])
def test_engine_refuses_whisper_and_windows_like_reference(arch, message):
    jcfg = jmake_smoke(jget_config(arch))
    cfg = make_smoke(get_config(arch))
    with pytest.raises(ValueError) as want:
        JServingEngine(jinit_params(jax.random.PRNGKey(0), jcfg), jcfg)
    with pytest.raises(ValueError) as got:
        ServingEngine(init_params(cfg, device="cpu"), cfg, device="cpu")
    assert str(got.value) == str(want.value) == message


def test_encdec_tail_prefill_and_paged_cross_read_are_refused():
    jcfg, cfg, jp, tp = _whisper("dense")
    tokens = np.zeros((1, 3), np.int32)
    tbl = np.zeros((1, 2), np.int32)
    with pytest.raises(ValueError) as want:
        lm_prefill(jp, jinit_caches(jcfg, 1, 8, jnp.float32),
                   {"tokens": jnp.asarray(tokens), "page_tables": jnp.asarray(tbl)},
                   jcfg, start_pos=4)
    with pytest.raises(ValueError) as got:
        tlm_prefill(tp, init_caches(cfg, 1, 8, torch.float32, "cpu"),
                    {"tokens": torch.from_numpy(tokens),
                     "page_tables": torch.from_numpy(tbl)}, cfg, start_pos=4)
    assert str(got.value) == str(want.value)
    assert "cross-attn" in str(got.value)
    pool = {"k": torch.zeros((3, 4, cfg.kv_heads, 32)),
            "v": torch.zeros((3, 4, cfg.kv_heads, 32))}
    with pytest.raises(ValueError, match="cross-attention reads"):
        attention_decode(tp["layers"][0]["cross"], torch.zeros((1, 1, cfg.d_model)),
                         pool, 4, num_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                         head_dim=32, update_cache=False,
                         page_table=torch.zeros((1, 2), dtype=torch.int32))


def test_whisper_config_dtypes_match_reference():
    """whisper-tiny's own dtypes: fp32 params under bf16 activations
    (mixed operands: the packed weights stay fp32, the activations are
    widened exactly into each product, as the reference's ``jnp.dot``
    promotes them).  Logits within 1e-2 of the largest |logit| (bf16):
    each layer rounds its outputs to bf16 and the two sides' fp32 sums
    differ in order, so roundings can land one bf16 ulp apart."""
    jcfg, cfg, jp, tp = _whisper("packed")
    jcfg, cfg = jcfg.replace(activ_dtype="bfloat16"), cfg.replace(activ_dtype="bfloat16")
    frames, tokens = _inputs(cfg, seed=2)
    jl = jlm_forward(jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
                     cfg=jcfg)[0]
    tl = tlm_forward(tp, {"tokens": torch.from_numpy(tokens),
                          "frames": torch.from_numpy(frames)}, cfg)[0]
    assert tl.dtype == torch.float32
    _close(tl, jl, tol=1e-2)
