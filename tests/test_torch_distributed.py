"""The port's multi-device substrate against the reference's.

* the axis rules (train, decode with and without a sequence-sharded
  cache, single and multi pod) are the reference's dicts;
* ``param_pspecs`` gives, for all ten archs' full-width param shapes
  (``jax.eval_shape`` of the reference's ``init_params``), the
  reference's specs with each ``PartitionSpec`` as a tuple, at the two
  production meshes' axis sizes (the reference reads only
  ``mesh.shape``, so a stand-in with that mapping serves);
* the production mesh's shapes, and its ``RuntimeError`` at world 1;
* ``compressed_psum_tree`` on 2 gloo ranks over ("pod", "data") (2, 1):
  with the same grads on both ranks (the only layout a global JAX array
  gives) equal to the reference's on 2 fake CPU devices (one JAX
  subprocess, run while the ranks run), with distinct grads equal to
  the protocol's numpy formula, and a passthrough without a "pod" axis
  or with one of size 1.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.models.transformer import init_params as jinit_params
from repro_torch.distributed import (make_decode_rules, make_mesh,
                                     make_train_rules, param_pspecs, run_ranks)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import compressed_psum_tree, init_error_buffers

ROOT = Path(__file__).resolve().parents[1]
MESH_SIZES = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}
SHAPES = {"w": (6, 40), "b": (33,), "blocks": [(3, 5, 7)]}
ERR_TOL = 1e-6


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", ["train", "decode", "decode_seq"])
def test_rules_are_the_references(multi_pod, kind):
    if kind == "train":
        got, want = make_train_rules(multi_pod), jsharding.make_train_rules(multi_pod)
    else:
        seq = kind == "decode_seq"
        got = make_decode_rules(multi_pod, shard_cache_seq=seq)
        want = jsharding.make_decode_rules(multi_pod, shard_cache_seq=seq)
    assert got == want


@functools.lru_cache(maxsize=None)
def _full_width_shapes(arch):
    cfg = ARCHS[arch]
    return jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), cfg))


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return None if tree is None else tuple(tree)


@pytest.mark.parametrize("mesh", sorted(MESH_SIZES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_pspecs_are_the_references(arch, mesh):
    shapes = _full_width_shapes(arch)
    sizes = MESH_SIZES[mesh]
    want = jsharding.param_pspecs(shapes, SimpleNamespace(shape=sizes))
    got = param_pspecs(shapes, sizes)
    assert got == _as_tuples(want)
    # a replicated fallback somewhere (mixtral's E=8, vocab 49155, ...)
    # and a sharded dim somewhere: the comparison is not vacuous
    flat = [s for s in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))]
    assert any(a is not None for s in flat for a in s)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_and_error_at_world_one(multi_pod):
    assert tmesh.make_mesh_shape(multi_pod=multi_pod) == \
        jmesh.make_mesh_shape(multi_pod=multi_pod)
    with pytest.raises(RuntimeError) as want:
        jmesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError) as got:
        tmesh.make_production_mesh(multi_pod=multi_pod)
    # the same needed/visible counts; the advice after the dash differs
    assert str(got.value).split(" — ")[0] == str(want.value).split(" — ")[0]
    assert "needs 256" in str(got.value) or "needs 512" in str(got.value)


_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.launch.mesh import make_test_mesh
    from repro.optim.compression import compressed_psum_tree

    inp = dict(np.load(sys.argv[1]))
    grads = {"w": jnp.asarray(inp["g/w"]), "b": jnp.asarray(inp["g/b"]),
             "blocks": [jnp.asarray(inp["g/blocks"]).astype(jnp.bfloat16)]}
    errors = {"w": jnp.asarray(inp["e/w"]), "b": jnp.asarray(inp["e/b"]),
              "blocks": [jnp.asarray(inp["e/blocks"])]}
    mesh = make_test_mesh((2, 1), ("pod", "data"))
    out, err = compressed_psum_tree(grads, errors, mesh)
    np.savez(sys.argv[2], **{"o/w": np.asarray(out["w"]), "o/b": np.asarray(out["b"]),
             "o/blocks": np.asarray(out["blocks"][0].astype(jnp.float32)),
             "n/w": np.asarray(err["w"]), "n/b": np.asarray(err["b"]),
             "n/blocks": np.asarray(err["blocks"][0])})
""")


def _tree(arrays, prefix):
    return {"w": torch.from_numpy(arrays[f"{prefix}/w"]),
            "b": torch.from_numpy(arrays[f"{prefix}/b"]),
            "blocks": [torch.from_numpy(arrays[f"{prefix}/blocks"])]}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in (("w", SHAPES["w"]), ("b", SHAPES["b"]),
                        ("blocks", SHAPES["blocks"][0])):
        out[f"g/{name}"] = rng.standard_normal(shape).astype(np.float32)
        out[f"e/{name}"] = (0.01 * rng.standard_normal(shape)).astype(np.float32)
    # bf16-representable, so the reference's bf16 leaf holds the same values
    out["g/blocks"] = torch.from_numpy(out["g/blocks"]).to(torch.bfloat16) \
        .float().numpy()
    return out


def _compression_ranks(rank, same, distinct):
    torch.set_num_threads(1)
    mesh = make_test_mesh((2, 1), ("pod", "data"), device_type="cpu")
    res = {}
    for name, arrays in (("same", same), ("distinct", distinct[rank])):
        g, e = _tree(arrays, "g"), _tree(arrays, "e")
        g["blocks"][0] = g["blocks"][0].to(torch.bfloat16)
        res[name] = compressed_psum_tree(g, e, mesh)
    g, e = _tree(same, "g"), _tree(same, "e")
    passthrough = []
    for shape, axes in (((2, 1), ("data", "model")), ((1, 2), ("pod", "data"))):
        other = make_mesh(shape, axes, device_type="cpu")
        out, err = compressed_psum_tree(g, e, other)
        passthrough.append(out is g and err is e)
    res["passthrough"] = passthrough
    res["zeros"] = init_error_buffers(g)
    return res


@pytest.fixture(scope="module")
def compression(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    same = _arrays(0)
    distinct = [_arrays(1), _arrays(2)]
    np.savez(d / "inputs.npz", **same)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF, str(d / "inputs.npz"), str(d / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = run_ranks(_compression_ranks, 2, backend="gloo",
                          device_type="cpu", init_file=d / "init",
                          args=(same, distinct))
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return dict(ranks=ranks, ref=dict(np.load(d / "ref.npz")), same=same,
                distinct=distinct)


def _leaves(tree):
    return {"w": tree["w"], "b": tree["b"], "blocks": tree["blocks"][0]}


def _scale(gfs):
    return max(max(np.abs(gf).max() for gf in gfs), 1e-12) / 127.0


@pytest.mark.parametrize("leaf", ["w", "b", "blocks"])
def test_compressed_psum_same_grads_equals_reference(compression, leaf):
    ref, same = compression["ref"], compression["same"]
    gf = same[f"g/{leaf}"] + same[f"e/{leaf}"]
    scale = np.float32(_scale([gf]))
    for out, err in (r["same"] for r in compression["ranks"]):
        o, n = _leaves(out)[leaf], _leaves(err)[leaf]
        assert o.dtype == (torch.bfloat16 if leaf == "blocks" else torch.float32)
        assert n.dtype == torch.float32
        np.testing.assert_allclose(o.float().numpy(), ref[f"o/{leaf}"],
                                   atol=ERR_TOL, rtol=0)
        np.testing.assert_allclose(n.numpy(), ref[f"n/{leaf}"], atol=ERR_TOL, rtol=0)
        # the quantized values themselves, exactly: q = (gf - e') / s
        q_port = np.rint((gf - n.numpy()) / scale)
        q_ref = np.rint((gf - ref[f"n/{leaf}"]) / scale)
        np.testing.assert_array_equal(q_port, q_ref)
        assert np.abs(q_port).max() <= 127


@pytest.mark.parametrize("leaf", ["w", "b", "blocks"])
def test_compressed_psum_distinct_grads_follows_the_protocol(compression, leaf):
    gfs = [a[f"g/{leaf}"] + a[f"e/{leaf}"] for a in compression["distinct"]]
    s = _scale(gfs)
    qs = [np.clip(np.round(gf / s), -127, 127) for gf in gfs]
    want_out = sum(qs) * s / 2
    for rank, r in enumerate(compression["ranks"]):
        out, err = r["distinct"]
        tol = 1e-2 * np.abs(want_out).max() if leaf == "blocks" else ERR_TOL
        np.testing.assert_allclose(_leaves(out)[leaf].float().numpy(), want_out,
                                   atol=tol, rtol=0)
        np.testing.assert_allclose(_leaves(err)[leaf].numpy(),
                                   gfs[rank] - qs[rank] * s, atol=ERR_TOL, rtol=0)


def test_compressed_psum_passthrough_and_error_buffers(compression):
    for r in compression["ranks"]:
        assert r["passthrough"] == [True, True]
        zeros = _leaves(r["zeros"])
        assert all(z.dtype == torch.float32 and not z.any() for z in zeros.values())
        assert zeros["blocks"].shape == SHAPES["blocks"][0]


def test_cuda_mesh_and_ranks_need_a_card(tmp_path, monkeypatch):
    """A mesh and ranks on the card by default; without one they raise
    (before any process group is touched) instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_test_mesh((1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(_compression_ranks, 1, backend="nccl", device_type="cuda",
                  init_file=tmp_path / "init")
    assert not list(tmp_path.iterdir())
