"""The port's per-layer rematerialization policies against the JAX
package's ``_remat_wrap``, on the CPU at smoke sizes.

``remat="dots"`` is the reference's ``dots_with_no_batch_dims_saveable``:
the backward keeps the outputs of the products without batch dims (the
projections and the router) and recomputes the rest; "full" keeps only
each layer's inputs; "none" checkpoints nothing.  Held here:

(a) per layer of qwen1.5-0.5b, granite-moe-1b-a400m and jamba-v0.1-52b
    smoke (8 layers, so one attention layer), the bytes the port keeps
    under "dots" beyond "full" (the port's ``CostCounter``: live bytes
    after the layer's forward) equal the bytes of the reference's saved
    residuals (``jax.ad_checkpoint.print_saved_residuals``), arguments
    left out, plus the differences named in ``_port_extra``;
(b) with the port's counter over a forward and backward: FLOPs none <
    dots < full, dots - none equal to the forward FLOPs of the batched
    products (attention's scores and values, the expert einsums, Mamba's
    read-out), computed here from the shapes; peaks full < dots < none;
    and the same counts from a trace under ``FakeTensorMode`` with the
    counter as the outer mode (the dry-run's arrangement);
(c) gradients under "dots" against ``jax.grad`` under the reference's
    "dots", within 1e-4 of each leaf's largest entry;
(d) the dry-run's sharded trace of a train step on a (2, 2) mesh of fake
    ranks orders FLOPs and peaks as (b) does.

The MoE all-to-all under "dots" on autograd's thread is held in
``tests/test_torch_moe_alltoall.py``, the DTensor step under "dots" in
``tests/test_torch_sharded_step.py``.
"""
import contextlib
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import print_saved_residuals
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.models import cross_entropy_loss as jcross_entropy_loss
from repro.models import init_params as jinit_params
from repro.models import lm_forward as jlm_forward
from repro.models import transformer as jtransformer
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, make_smoke
from repro_torch.core.masks import map_tree
from repro_torch.core.structures import iter_leaves
from repro_torch.distributed.cost import CostCounter
from repro_torch.models import cross_entropy_loss, init_params, layer_specs, lm_forward
from repro_torch.models import transformer

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "jamba-v0.1-52b")
LAYERS = {"jamba-v0.1-52b": 8}         # at 4 layers jamba-smoke has no attention
GRAD_TOL = 1e-4
B, S = 2, 16
_CACHE = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(arch):
    """(jax cfg, torch cfg, jax params, torch params), smoke size, under
    "dots" on both sides."""
    if arch not in _CACHE:
        n = LAYERS.get(arch, 4)
        jcfg = jmake_smoke(jget_config(arch), n_layers=n, remat="dots")
        cfg = make_smoke(get_config(arch), n_layers=n, remat="dots")
        jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
        _CACHE[arch] = (jcfg, cfg, jparams, params_from_reference(jparams))
    return _CACHE[arch]


def _fresh(tree):
    return map_tree(lambda t: t.detach().clone().requires_grad_(True), tree)


# -- (a) residuals ---------------------------------------------------------------

_AVAL = re.compile(r"^(bf16|f32|f16|i32|bool)\[([0-9,]*)\] (.*)$")
_ITEM = {"bf16": 2, "f16": 2, "f32": 4, "i32": 4, "bool": 1}


def _reference_residuals(jcfg, jlp, spec_index, x, pos):
    """[(bytes, description)] of the reference's saved residuals of one
    layer under ``_remat_wrap``, its arguments left out, as
    ``print_saved_residuals`` prints them."""
    spec = jtransformer.layer_specs(jcfg)[spec_index]
    fn = jtransformer._remat_wrap(
        functools.partial(jtransformer._apply_layer, spec=spec, cfg=jcfg), jcfg)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(
            lambda p, x, pos: fn(p, x=x, positions=pos, enc_out=None),
            jlp, jnp.asarray(x), jnp.asarray(pos))
    out = []
    for line in buf.getvalue().splitlines():
        m = _AVAL.match(line.strip())
        assert m, line
        if "from the argument" in m.group(3):
            continue
        dims = [int(d) for d in m.group(2).split(",") if d]
        out.append((_ITEM[m.group(1)] * math.prod(dims), m.group(3)))
    return out


def _port_kept(lp, spec, cfg, x, pos, remat):
    """Live bytes, beyond the layer's inputs, after ``_run_layer``'s
    forward under ``remat`` (its output included)."""
    lp = _fresh(lp)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(pos)
    with CostCounter(live=(lp, xt, pt)) as c:
        out = transformer._run_layer(lp, xt, pt, None, spec, cfg.replace(remat=remat))
        kept = c.live_bytes - c.baseline_bytes
    del out
    return kept


def _port_extra(spec, cfg):
    """Bytes the port keeps that the reference does not, with the reason.

    * A dense MLP's ``w_down`` output: the residual add after it needs
      neither operand in its backward, so the reference's partial
      evaluation drops it; the torch policy decides per op at dispatch,
      before the backward is known, and keeps every unbatched product.
      (Where the reference keeps the jitted ``silu``'s output of the
      gate, the port keeps the gate's product: the same shape and bytes,
      so it is no difference in bytes.)"""
    extra = {}
    if spec.mlp == "dense":
        extra["w_down output (no backward node needs it)"] = B * S * cfg.d_model * 4
    return extra


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_the_references_residuals(arch):
    jcfg, cfg, jparams, tparams = _model(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    specs = layer_specs(cfg)
    assert {sp.mlp for sp in specs} >= ({"moe"} if cfg.moe_experts else {"dense"})
    for i, (jlp, lp, spec) in enumerate(zip(jparams["layers"], tparams["layers"], specs)):
        ref = _reference_residuals(jcfg, jlp, i, x, pos)
        assert ref, (i, spec)
        kept = (_port_kept(lp, spec, cfg, x, pos, "dots")
                - _port_kept(lp, spec, cfg, x, pos, "full"))
        want = sum(n for n, _ in ref) + sum(_port_extra(spec, cfg).values())
        assert kept == want, (i, spec, kept, ref, _port_extra(spec, cfg))


# -- (b) the port's counter ----------------------------------------------------------

def _batched_forward_flops(cfg, b, s):
    """Forward FLOPs of the products with batch dims, from the shapes:
    chunked causal attention's scores and values (chunks of
    ``cfg.attn_chunk`` queries over the keys up to the chunk's end), the
    expert einsums over the capacity rows (``moe.moe_apply``: b groups
    of s tokens, ``cap = max(ceil(s k cf / E), k)``) and Mamba's
    read-out (B, L, di, N) x (B, L, N)."""
    total = 0
    dh = cfg.head_dim_()
    for spec in layer_specs(cfg):
        if spec.mixer == "attn":
            chunk = min(cfg.attn_chunk, s)
            pairs = sum((qe - qs) * qe for qs in range(0, s, chunk)
                        for qe in [min(qs + chunk, s)])
            total += 2 * (2 * b * cfg.n_heads * dh * pairs)
        elif spec.mixer == "mamba":
            total += 2 * b * s * (2 * cfg.d_model) * cfg.d_state
        if spec.mlp == "moe":
            e, k = cfg.moe_experts, cfg.moe_top_k
            cap = max(int(math.ceil(s * k * cfg.capacity_factor / e)), k)
            mats = 3 if cfg.gated_mlp else 2
            total += mats * 2 * b * e * cap * cfg.d_model * cfg.d_ff
    return total


def _count(cfg, params, toks):
    """(FLOPs, peak bytes above the state) of one forward and backward of
    the loss under the port's counter."""
    live = _fresh(params)
    with CostCounter(live=(live, toks)) as c:
        logits, aux = lm_forward(live, {"tokens": toks}, cfg)
        loss = cross_entropy_loss(logits, toks) + 0.01 * aux["moe_aux"]
        loss.backward()
    return c.flops, c.peak_bytes - c.baseline_bytes


def _count_fake(cfg, toks):
    """``_count`` of fresh params traced under ``FakeTensorMode``, the
    counter entered inside it, as the dry-run does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = map_tree(lambda t: t.requires_grad_(True),
                          init_params(cfg, device="cpu"))
        ftoks = torch.zeros(toks.shape, dtype=toks.dtype)
        with CostCounter(live=(params, ftoks)) as c:
            logits, aux = lm_forward(params, {"tokens": ftoks}, cfg)
            loss = cross_entropy_loss(logits, ftoks) + 0.01 * aux["moe_aux"]
            loss.backward()
    return c.flops, c.peak_bytes - c.baseline_bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_recomputes_only_the_batched_products(arch):
    _, cfg, _, params = _model(arch)
    b, s = 8, 64
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s), dtype=np.int64))
    got = {r: _count(cfg.replace(remat=r), params, toks)
           for r in ("none", "dots", "full")}
    flops = {r: v[0] for r, v in got.items()}
    peak = {r: v[1] for r, v in got.items()}
    assert flops["none"] < flops["dots"] < flops["full"], flops
    assert flops["dots"] - flops["none"] == _batched_forward_flops(cfg, b, s)
    assert peak["full"] < peak["dots"] < peak["none"], peak
    # the selective mode inside the counter under fake tensors: a kept
    # product is counted once and stays live until its layer's backward
    assert _count_fake(cfg, toks) == got["dots"]


# -- (c) gradients ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_match_jax_grad(arch):
    jcfg, cfg, jparams, tparams = _model(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = np.random.default_rng(4).integers(0, cfg.vocab, (B, S), dtype=np.int32)

    def jloss(p):
        logits, aux = jlm_forward(p, {"tokens": jnp.asarray(toks)}, jcfg)
        return jcross_entropy_loss(logits, jnp.asarray(labels)) + 0.01 * aux["moe_aux"]

    jgrads = params_from_reference(jax.jit(jax.grad(jloss))(jparams))
    live = _fresh(tparams)
    logits, aux = lm_forward(live, {"tokens": torch.from_numpy(toks)}, cfg)
    loss = (cross_entropy_loss(logits, torch.from_numpy(labels))
            + 0.01 * aux["moe_aux"])
    loss.backward()
    want = dict(iter_leaves(jgrads))
    n = 0
    for path, t in iter_leaves(live):
        w = want.pop(path).float().numpy()
        g = t.grad.float().numpy()
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-12), path
        n += 1
    assert not want and n >= 4 * 7


# -- (d) the dry-run's sharded trace -----------------------------------------------

_SHARDED = textwrap.dedent("""
    import json
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    dryrun.fake_world(4)
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    for arch in %(archs)r:
        for remat in ("none", "dots", "full"):
            cfg = make_smoke(get_config(arch), d_model=256, n_heads=4, kv_heads=2,
                             head_dim=64, vocab=512, remat=remat)
            counter, _ = dryrun.trace_cell(cfg, ShapeCell("t", "train", 64, 32), mesh)
            out[f"{arch}/{remat}"] = [counter.flops,
                                      counter.peak_bytes - counter.baseline_bytes]
    print(json.dumps(out))
""")


def test_sharded_dry_run_orders_the_policies():
    archs = ["qwen1.5-0.5b", "granite-moe-1b-a400m"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SHARDED % {"archs": archs}],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch in archs:
        (fn, pn), (fd, pd), (ff, pf) = (out[f"{arch}/{r}"] for r in ("none", "dots", "full"))
        assert fn < fd < ff, (arch, fn, fd, ff)
        assert pf < pd < pn, (arch, pf, pd, pn)
