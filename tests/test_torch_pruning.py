"""Pruning and packing of the port against the JAX package, on the CPU.

The same params (initialised in JAX, carried over with
``repro_torch.bridge``) go through both ``knapsack_prune``s: the
selections must be identical, and so must every mask.  ``pack_bsr`` /
``pack_params`` must give the identical BSR layout — ``indices``,
``slots``, ``flat_rows``, ``flat_cols`` and the flat store of blocks —
in fp32 and bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core import BlockingSpec as JBlockingSpec
from repro.core import pack_bsr as jpack_bsr
from repro.core.masks import _get_path as jget_path
from repro.core.structures import structure_norms_dense as jnorms
from repro.models import init_params as jinit_params
from repro.sparse import knapsack_prune as jknapsack_prune
from repro.sparse import pack_params as jpack_params
from repro_torch.bridge import params_from_reference, tensor_from_reference
from repro_torch.core import BlockingSpec, BSRWeight, bsr_to_dense, pack_bsr
from repro_torch.core.masks import _get_path
from repro_torch.core.structures import iter_leaves, structure_norms_dense
from repro_torch.sparse import knapsack_prune, pack_params, sparsity_summary

FIELDS = ("indices", "slots", "flat_rows", "flat_cols", "blocks")


def _smoke_params():
    cfg = jmake_smoke(jget_config("qwen1.5-0.5b"), n_layers=2)
    jparams = jinit_params(jax.random.PRNGKey(0), cfg)
    return jparams, params_from_reference(jparams)


def _assert_same_bsr(tb, jb, where=""):
    assert tb.shape == tuple(jb.shape), where
    assert (tb.blocking.bk, tb.blocking.bn) == (jb.blocking.bk, jb.blocking.bn)
    assert tb.nnz_blocks == jb.nnz_blocks, where
    for f in FIELDS:
        got, want = getattr(tb, f), tensor_from_reference(getattr(jb, f))
        assert got.dtype == want.dtype, (where, f)
        assert torch.equal(got, want), (where, f)


@pytest.mark.parametrize("sparsity,block", [
    (0.75, (128, 128)),     # one tile per smoke weight: all values tie at 1
    (0.75, (32, 32)),
    (0.5, (32, 32)),
])
def test_knapsack_prune_selects_identically(sparsity, block):
    jparams, tparams = _smoke_params()
    kw = dict(sparsity=sparsity, min_size=1024)
    jsel = jknapsack_prune(jparams, blocking=JBlockingSpec(*block), **kw)
    tsel = knapsack_prune(tparams, blocking=BlockingSpec(*block), **kw)
    assert [i.path for i in tsel.structures.infos] == \
        [i.path for i in jsel.structures.infos]
    assert tsel.result.method == jsel.result.method
    np.testing.assert_array_equal(tsel.result.x, jsel.result.x)
    assert tsel.kept == jsel.kept and tsel.total == jsel.total
    for info in tsel.structures.infos:
        np.testing.assert_array_equal(
            _get_path(tsel.masks, info.path).numpy(),
            np.asarray(jget_path(jsel.masks, info.path)), err_msg=info.path)


def test_structure_norms_match_reference():
    jparams, tparams = _smoke_params()
    jsel = jknapsack_prune(jparams, sparsity=0.5,
                           blocking=JBlockingSpec(32, 32), min_size=1024)
    for info in jsel.structures.infos:
        want = np.asarray(jnorms(jget_path(jparams, info.path), info))
        got = structure_norms_dense(_get_path(tparams, info.path), info)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k,n,bk,bn,density", [
    (130, 50, 32, 32, 0.6),     # ragged tails
    (256, 384, 64, 128, 0.3),   # padding slots in some columns
    (64, 64, 64, 64, 0.0),      # fully pruned: one zero block
    (96, 96, 32, 32, 1.0),
])
def test_pack_bsr_layout_identical(k, n, bk, bn, density, dtype):
    rng = np.random.default_rng(k + n + bk)
    w = jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)).astype(dtype)
    gk, gn = -(-k // min(bk, k)), -(-n // min(bn, n))
    alive = rng.uniform(size=(gk, gn)) < density
    mask = np.repeat(np.repeat(alive, min(bk, k), 0), min(bn, n), 1)[:k, :n]
    jb = jpack_bsr(w, JBlockingSpec(bk=bk, bn=bn), mask=mask.astype(np.float32))
    tb = pack_bsr(tensor_from_reference(w), BlockingSpec(bk=bk, bn=bn),
                  mask=torch.from_numpy(mask.astype(np.float32)))
    _assert_same_bsr(tb, jb)
    dense = tensor_from_reference(w) * torch.from_numpy(mask).to(tb.blocks.dtype)
    assert torch.equal(bsr_to_dense(tb), dense)


def test_pack_params_identical_and_summary():
    jparams, tparams = _smoke_params()
    jsel = jknapsack_prune(jparams, sparsity=0.75,
                           blocking=JBlockingSpec(32, 32), min_size=1024)
    tsel = knapsack_prune(tparams, sparsity=0.75,
                          blocking=BlockingSpec(32, 32), min_size=1024)
    jpacked = jpack_params(jparams, jsel.masks, jsel.structures)
    tpacked = pack_params(tparams, tsel.masks, tsel.structures)
    bridged = params_from_reference(jpacked)
    n_packed = 0
    for path, leaf in iter_leaves(tpacked):
        other = _get_path(bridged, path)
        if isinstance(leaf, BSRWeight):
            _assert_same_bsr(leaf, jget_path(jpacked, path), path)
            n_packed += 1
        else:
            assert torch.equal(leaf, other), path
    assert n_packed == len(tsel.structures.infos) == 14
    summ = sparsity_summary(tpacked)
    assert summ["nnz_blocks"] == tsel.kept
    assert summ["total_blocks"] == tsel.total
