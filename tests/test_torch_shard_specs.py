"""The dry-run's cells and sharding specs against the reference's, at the
production meshes' sizes.

For every (arch, shape, mesh) of the 10 archs x 4 shapes x {(16, 16),
(2, 16, 16)}: ``cell_applicable``, the shapes and dtypes of
``input_specs`` (the port's meta stand-ins against the reference's
``ShapeDtypeStruct``s, caches included) and the ``cell_shardings`` trees
(params or train state, batch, caches) are the reference's, each
``PartitionSpec`` as a tuple.  The reference reads only ``mesh.shape``,
so a stand-in with that mapping serves; the port takes the mapping of
axis sizes.  The port's own state comes from its ``init_train_state``
over ``init_params`` under ``FakeTensorMode`` (nothing allocated).

Also: the ring model ``_wire``, ``roofline_terms`` at ``TPU_V5E``,
``model_flops`` and the supplements' ``*_trips`` equal the reference's.
"""
import functools
from types import SimpleNamespace

import jax
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import input_specs as jinput_specs
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.launch import supplements as jsupplements
from repro.models.transformer import init_params as jinit_params
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.train_step import init_train_state as jinit_train_state
from repro_torch.configs import SHAPES, cell_applicable, get_config, input_specs
from repro_torch.core.resource_model import TPU_V5E
from repro_torch.launch import roofline, specs, supplements
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state

MESH_SIZES = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


@functools.lru_cache(maxsize=None)
def _jstate(arch, train):
    cfg = JARCHS[arch]
    opt = JAdamWConfig(use_master=cfg.param_dtype != "float32")
    if train:
        return jax.eval_shape(
            lambda: jinit_train_state(jinit_params(jax.random.PRNGKey(0), cfg), opt))
    return {"params": jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), cfg))}


@functools.lru_cache(maxsize=None)
def _tstate(arch, train):
    cfg = get_config(arch)
    opt = AdamWConfig(use_master=cfg.param_dtype != "float32")
    with FakeTensorMode():
        params = init_params(cfg, device="cpu")
        return init_train_state(params, opt) if train else {"params": params}


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return None if tree is None else tuple(tree)


def _shapes_dtypes(tree):
    """(keystr-like path, shape, dtype name) of every leaf."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node is not None:
            out.append((path, tuple(int(d) for d in node.shape),
                        str(node.dtype).replace("torch.", "")))
    walk(tree, "")
    return out


@pytest.mark.parametrize("mesh", sorted(MESH_SIZES))
@pytest.mark.parametrize("shape", sorted(JSHAPES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_cell_specs_and_shardings_are_the_references(arch, shape, mesh):
    jcfg, cfg = JARCHS[arch], get_config(arch)
    jcell, cell = JSHAPES[shape], SHAPES[shape]
    assert (cell.name, cell.kind, cell.seq_len, cell.global_batch) == \
        (jcell.name, jcell.kind, jcell.seq_len, jcell.global_batch)
    assert cell_applicable(cfg, cell) == jcell_applicable(jcfg, jcell)
    if not cell_applicable(cfg, cell)[0]:
        return
    multi = mesh == "multi"
    sizes = MESH_SIZES[mesh]
    jspec, tspec = jinput_specs(jcfg, jcell), input_specs(cfg, cell)
    assert sorted(tspec) == sorted(jspec)
    assert _shapes_dtypes(tspec["batch"]) == _shapes_dtypes(jspec["batch"])
    if cell.kind == "decode":
        assert _shapes_dtypes(tspec["caches"]) == _shapes_dtypes(jspec["caches"])
        assert tuple(tspec["cache_len"].shape) == tuple(jspec["cache_len"].shape)
    train = cell.kind == "train"
    want = jspecs.cell_shardings(jcfg, jcell, SimpleNamespace(shape=sizes), multi,
                                 jspec, state_shapes=_jstate(arch, train))
    got = specs.cell_shardings(cfg, cell, sizes, multi, tspec,
                               state_shapes=_tstate(arch, train))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == _as_tuples(want[key]), key
    assert specs.rules_for_cell(cell, sizes, multi) == \
        jspecs.rules_for_cell(jcell, SimpleNamespace(shape=sizes), multi)


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter",
                                  "all-to-all", "collective-permute", "other"])
def test_wire_and_terms_are_the_references(kind):
    for nbytes in (0, 1, 4096, 123457):
        for g in (1, 2, 16, 512):
            assert roofline._wire(kind, nbytes, g) == jroofline._wire(kind, nbytes, g)
    args = (3.7e14, 1.1e12, 2.5e10)
    assert roofline.roofline_terms(*args, hw=TPU_V5E) == \
        jroofline.roofline_terms(*args)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_model_flops_and_supplement_trips_are_the_references(arch):
    for shape in JSHAPES:
        assert roofline.model_flops(get_config(arch), SHAPES[shape]) == \
            jroofline.model_flops(JARCHS[arch], JSHAPES[shape])
    assert get_config(arch).param_count() == JARCHS[arch].param_count()
    assert get_config(arch).active_param_count() == JARCHS[arch].active_param_count()
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        kw = dict(model_size=16, dp_size=16)
        want = jsupplements.supplements_for(JARCHS[arch], JSHAPES[shape], **kw)
        got = supplements.supplements_for(get_config(arch), SHAPES[shape], **kw)
        assert {k: v for k, v in got.items() if k.endswith("_trips")} == \
            {k: v for k, v in want.items() if k.endswith("_trips")}
        # the port traces every trip: nothing is added a second time
        assert got.get("flops", 0.0) == 0.0 and got.get("bytes", 0.0) == 0.0
        assert all(got[k] > 0 for k in got if k.endswith("_body_flops"))
        assert bool(got) == bool(want)
