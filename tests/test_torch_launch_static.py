"""The port's fixed-batch launcher at prompt length 0 against the reference's.

With no prompt, the reference (``src/repro/launch/serve.py:155-197``)
skips the prefill and starts ``lm_generate`` from token 0, a stand-in
BOS, at cache length 0; the port's ``_run_static`` does the same.  Both
launchers run with ``--smoke --prompt-len 0 --gen 4`` on the CPU, the
port on the reference's params bridged to torch (its ``build_params``
replaced) and, for whisper-tiny, on the reference's frame embeddings
(no prompt is drawn, so the launchers' prompt draws do not matter).  The
printed greedy samples must be equal, the port must print its prefill
time, and every row of the port's stream must equal the reference's
``lm_generate`` from token 0 on the same params.
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
from repro.models.transformer import encode_kv_caches as jencode_kv_caches
from repro.models.transformer import encoder_forward as jencoder_forward
from repro_torch.bridge import params_from_reference, tensor_from_reference
from repro_torch.launch import serve

GEN, BATCH = 4, 4


def _sample_line(out: str) -> str:
    lines = [l for l in out.splitlines() if l.startswith("sample:")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_fixed_batch_at_prompt_length_zero_matches_reference(arch, monkeypatch,
                                                             capsys):
    argv = ["--arch", arch, "--smoke", "--prompt-len", "0", "--gen", str(GEN)]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    assert jserve.main() == 0
    want_line = _sample_line(capsys.readouterr().out)

    jcfg = jmake_smoke(jget_config(arch))
    key_params, _, key_frames, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    jparams = jinit_params(key_params, jcfg)
    caches = jinit_caches(jcfg, BATCH, GEN, jnp.float32)
    frames = None
    if jcfg.enc_layers:
        frames = jax.random.normal(key_frames,
                                   (BATCH, jcfg.enc_frames, jcfg.d_model))
        caches = jencode_kv_caches(jparams, jencoder_forward(jparams, frames, jcfg),
                                   jcfg, caches)
    want, _ = jlm_generate(jparams, caches, jnp.zeros((BATCH, 1), jnp.int32),
                           jnp.asarray(0, jnp.int32), GEN, jcfg)

    monkeypatch.setattr(serve, "build_params", lambda cfg, **kw: (
        params_from_reference(jparams, "cpu"), None))
    monkeypatch.setattr(serve, "static_inputs", lambda cfg, **kw: (
        torch.zeros((BATCH, 0), dtype=torch.int64),
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
