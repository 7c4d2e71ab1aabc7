"""The port's config registry, the sliding-window ring cache and the logit
softcap against the JAX package, on the CPU.

* every arch of the reference's registry resolves in the port, field for
  field (deepseek-7b, deepseek-67b, mixtral-8x7b and command-r-plus-104b
  need no new module; whisper-tiny and qwen2-vl-2b are the
  encoder-decoder and multimodal families);
* the smoke configs of the four (mixtral at capacity factor E/k, where
  no token drops) build with the reference's param tree, and
  ``lm_forward`` on JAX-initialised params carried over with
  ``repro_torch.bridge`` agrees with the reference's;
* the contiguous SWA ring: mixtral smoke at ``window=8`` over a 20-token
  prompt (prefill keeps the last 8 tokens at their decode slots) and
  decode past the window, prefill and per-token decode logits and greedy
  ``lm_generate`` tokens against JAX (the reference's
  ``test_swa_ring_buffer_decode``);
* ``logits_softcap=30.0`` in forward, prefill and decode.

Logits within 1e-4 of the largest |logit| (fp32), tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import lm_decode, lm_forward, lm_generate, lm_prefill
from repro_torch.bridge import params_from_reference
from repro_torch.configs import ARCHS, get_config, make_smoke
from repro_torch.core.structures import iter_leaves
from repro_torch.models import init_caches, init_params
from repro_torch.models import lm_decode as tlm_decode
from repro_torch.models import lm_forward as tlm_forward
from repro_torch.models import lm_generate as tlm_generate
from repro_torch.models import lm_prefill as tlm_prefill

from chip_smoke import EMBED_SCALE

TOL = 1e-4                 # of max(1, max |ref|), fp32
NEW = ["deepseek-7b", "deepseek-67b", "mixtral-8x7b", "command-r-plus-104b"]
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
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    assert err <= tol, err


def _smoke(arch, **over):
    if arch == "mixtral-8x7b":
        over = {"capacity_factor": 8.0, **over}
    return jmake_smoke(jget_config(arch), **over), make_smoke(get_config(arch), **over)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_every_reference_arch_registers_field_for_field(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    assert _fields(get_config(arch)) == _fields(jget_config(arch))
    assert _fields(make_smoke(get_config(arch))) == _fields(jmake_smoke(jget_config(arch)))


@pytest.mark.parametrize("arch", NEW)
def test_config_smoke_builds_and_forward_matches_reference(arch):
    jcfg, cfg = _smoke(arch)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jp)
    ours = init_params(cfg, device="cpu")
    assert {p: tuple(t.shape) for p, t in iter_leaves(ours)} == {
        p: tuple(t.shape) for p, t in iter_leaves(tp)}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 11)).astype(np.int32)
    jl = jlm_forward(jp, {"tokens": jnp.asarray(tokens)}, cfg=jcfg)[0]
    tl = tlm_forward(tp, {"tokens": torch.from_numpy(tokens)}, cfg)[0]
    _close(tl, jl)


def _pair(arch, **over):
    jcfg, cfg = _smoke(arch, **over)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    jp = {**jp, "embed": {"embedding": jp["embed"]["embedding"] * EMBED_SCALE}}
    return jcfg, cfg, jp, params_from_reference(jp)


def _prefill_decode_generate(arch, s, gen, **over):
    """Prefill S tokens, then per-token greedy decode against JAX's
    decode and greedy lm_generate tokens against JAX's.  Returns the
    generated tokens."""
    jcfg, cfg, jp, tp = _pair(arch, **over)
    b = 2
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    jc = jinit_caches(jcfg, b, s + gen, jnp.float32)
    tc = init_caches(cfg, b, s + gen, torch.float32, "cpu")
    jl, jc = jlm_prefill(jp, jc, {"tokens": jnp.asarray(tokens)}, cfg=jcfg)
    tl, tc = tlm_prefill(tp, tc, {"tokens": torch.from_numpy(tokens)}, cfg)
    _close(tl, jl)
    _close(tl, tlm_forward(tp, {"tokens": torch.from_numpy(tokens)}, cfg)[0])
    for c_t, c_j in zip(tc, jc):
        _close(c_t["k"], c_j["k"])
    first = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    snap = [{k: v.clone() for k, v in c.items()} for c in tc]
    jt, _ = jlm_generate(jp, jc, jnp.asarray(first.numpy()), jnp.asarray(s, jnp.int32),
                         num_tokens=gen, cfg=jcfg)
    tt, _ = tlm_generate(tp, tc, first, s, gen, cfg)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    tok, caches = first, snap
    jcs = jinit_caches(jcfg, b, s + gen, jnp.float32)
    _, jcs = jlm_prefill(jp, jcs, {"tokens": jnp.asarray(tokens)}, cfg=jcfg)
    for i in range(gen):
        assert np.array_equal(tok[:, 0].numpy(), tt[:, i].numpy())
        td, caches = tlm_decode(tp, caches, {"tokens": tok}, s + i, cfg)
        jd, jcs = jlm_decode(jp, jcs, {"tokens": jnp.asarray(tok.numpy())},
                             jnp.asarray(s + i, jnp.int32), cfg=jcfg)
        _close(td, jd)
        tok = td[:, -1].argmax(-1).to(torch.int32)[:, None]
    return tt, cfg


def test_swa_ring_prefill_and_decode_match_reference():
    tt, cfg = _prefill_decode_generate("mixtral-8x7b", s=20, gen=10, window=8)
    assert cfg.window == 8 and cfg.capacity_factor == 8.0
    caches = init_caches(cfg, 2, 30, torch.float32, "cpu")
    assert caches[0]["k"].shape[1] == 8                     # a ring of the window
    assert len(set(tt.flatten().tolist())) >= 4


def test_logit_softcap_in_forward_prefill_and_decode_matches_reference():
    tt, cfg = _prefill_decode_generate("qwen1.5-0.5b", s=9, gen=6, logits_softcap=30.0)
    assert cfg.logits_softcap == 30.0
    # the cap binds: logits of the un-scaled model reach past it
    jcfg, cfg = _smoke("qwen1.5-0.5b", logits_softcap=30.0)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jp)
    tokens = np.arange(12, dtype=np.int32)[None] % cfg.vocab
    tl = tlm_forward(tp, {"tokens": torch.from_numpy(tokens)}, cfg)[0]
    raw = tlm_forward(tp, {"tokens": torch.from_numpy(tokens)},
                      cfg.replace(logits_softcap=None))[0]
    assert float(raw.abs().max()) > 30.0 > float(tl.abs().max())
    _close(tl, jlm_forward(jp, {"tokens": jnp.asarray(tokens)}, cfg=jcfg)[0])
