"""The port's fixed-batch launcher against the reference's, at prompt
lengths 0 and 6.

With no prompt, the reference (``src/repro/launch/serve.py:155-197``)
skips the prefill and starts ``lm_generate`` from token 0, a stand-in
BOS, at cache length 0; with one, a single ``lm_prefill`` over the
prompt gives the first token and ``lm_generate`` goes on from the
prompt's length.  The port's ``_run_static`` does the same.  Both
launchers run with ``--smoke --prompt-len P --gen 4`` on the CPU, the
port on the reference's params bridged to torch (its ``build_params``
replaced) and on the reference's inputs (its ``static_inputs``
replaced: the prompt drawn from ``key_prompt`` and, for whisper-tiny,
the frame embeddings from ``key_frames``, as the reference's launcher
draws them).  The printed greedy samples must be equal, the port must
print its prefill time, and every row of the port's stream must equal
the reference's ``lm_generate`` after its prefill on the same params.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models as tmodels
from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.launch import serve as jserve
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import lm_generate as jlm_generate
from repro.models import lm_prefill as jlm_prefill
from repro.models.transformer import encode_kv_caches as jencode_kv_caches
from repro.models.transformer import encoder_forward as jencoder_forward
from repro_torch.bridge import params_from_reference, tensor_from_reference
from repro_torch.launch import serve

GEN, BATCH = 4, 4


def _sample_line(out: str) -> str:
    lines = [l for l in out.splitlines() if l.startswith("sample:")]
    assert len(lines) == 1, out
    return lines[0]


def _check_against_reference(arch, plen, monkeypatch, capsys):
    argv = ["--arch", arch, "--smoke", "--prompt-len", str(plen), "--gen", str(GEN)]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    assert jserve.main() == 0
    want_line = _sample_line(capsys.readouterr().out)

    jcfg = jmake_smoke(jget_config(arch))
    key_params, key_prompt, key_frames, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    jparams = jinit_params(key_params, jcfg)
    caches = jinit_caches(jcfg, BATCH, max(plen + GEN, 1), jnp.float32)
    prompt = jax.random.randint(key_prompt, (BATCH, max(plen, 1)), 0, jcfg.vocab)
    frames = None
    if jcfg.enc_layers:
        frames = jax.random.normal(key_frames,
                                   (BATCH, jcfg.enc_frames, jcfg.d_model))
        caches = jencode_kv_caches(jparams, jencoder_forward(jparams, frames, jcfg),
                                   jcfg, caches)
    if plen > 0:
        logits, caches = jlm_prefill(jparams, caches, {"tokens": prompt}, jcfg)
        first = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    else:
        first = jnp.zeros((BATCH, 1), jnp.int32)
    want, _ = jlm_generate(jparams, caches, first, jnp.asarray(plen, jnp.int32),
                           GEN, jcfg)

    monkeypatch.setattr(serve, "build_params", lambda cfg, **kw: (
        params_from_reference(jparams, "cpu"), None))
    monkeypatch.setattr(serve, "static_inputs", lambda cfg, **kw: (
        tensor_from_reference(prompt[:, :plen], "cpu").long(),
        None if frames is None else tensor_from_reference(frames, "cpu")))
    streams = []
    generate = tmodels.lm_generate

    def recorded(*a, **kw):
        toks, c = generate(*a, **kw)
        streams.append(toks.clone())
        return toks, c

    monkeypatch.setattr(tmodels, "lm_generate", recorded)
    assert serve.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _sample_line(out) == want_line
    assert "(prefill " in out and f"generated ({BATCH}, {GEN}) tokens" in out
    assert len(streams) == 2                     # warm-up and the timed run
    for toks in streams:
        np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_fixed_batch_at_prompt_length_zero_matches_reference(arch, monkeypatch,
                                                             capsys):
    _check_against_reference(arch, 0, monkeypatch, capsys)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_fixed_batch_after_a_prompt_matches_reference(arch, monkeypatch, capsys):
    _check_against_reference(arch, 6, monkeypatch, capsys)


def _fixed_batch(arch, plen, sampling, device, cuda_graphs=None):
    """The launcher's ``FixedBatch`` on smoke params from a seed, with
    its own inputs and key (B 4, 4 tokens)."""
    from repro_torch import prng
    from repro_torch.configs import get_config, make_smoke
    cfg = make_smoke(get_config(arch))
    params, _ = serve.build_params(cfg, seed=0, device=device)
    prompt, frames = serve.static_inputs(cfg, batch=BATCH, prompt_len=plen,
                                         seed=0, device=device)
    key = prng.split(prng.PRNGKey(0), 4)[3]
    return serve.FixedBatch(params, cfg, prompt, frames, GEN, key=key,
                            device=device, cuda_graphs=cuda_graphs, **sampling)


SAMPLINGS = {"greedy": {}, "sampled": dict(temperature=0.8, top_k=5, top_p=0.9)}


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("plen", [0, 6])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_fixed_batch_resets_its_static_caches(arch, plen, sampling):
    """The caches are allocated once and reset in place: a second call
    gives the first call's tokens, greedy and sampled (one fixed key)."""
    run = _fixed_batch(arch, plen, SAMPLINGS[sampling], "cpu")
    caches = [dict(c) for c in run.caches]
    first, _, _ = run()
    second, _, _ = run()
    assert first.shape == (BATCH, GEN)
    np.testing.assert_array_equal(first, second)
    assert all(c[k] is t for c, cc in zip(run.caches, caches) for k, t in cc.items())
    with pytest.raises(ValueError, match="CUDA device"):
        _fixed_batch(arch, plen, {}, "cpu", cuda_graphs=True)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("plen", [0, 6])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_graphed_fixed_batch_equals_eager(arch, plen, sampling):
    """On the card: the graphed prefill and ``lm_generate`` (captured in
    the first call, replayed in the second) give the eager path's tokens,
    greedy and sampled."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    card = torch.device("cuda")
    want, _, _ = _fixed_batch(arch, plen, SAMPLINGS[sampling], card,
                              cuda_graphs=False)()
    run = _fixed_batch(arch, plen, SAMPLINGS[sampling], card)
    for _ in range(2):
        got, _, _ = run()
        np.testing.assert_array_equal(got, want)
    assert {k: v["replays"] for k, v in run.stats().items()} == (
        {"prefill": 1, "generate": 1} if plen else {"generate": 1})
