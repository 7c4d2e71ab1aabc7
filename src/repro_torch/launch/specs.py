"""Per-cell sharding specs: params / optimizer state / batch / caches —
torch port of ``src/repro/launch/specs.py``.

Every divisibility-aware placement decision of the dry-run lives here.
The helpers return spec trees of the form ``param_pspecs`` returns: one
tuple per leaf, an axis name, a tuple of names or ``None`` per dim (the
reference's ``PartitionSpec``); ``tree_placements`` turns a spec tree into
DTensor placements over a mesh (the reference's ``tree_named``).  ``mesh``
is a ``DeviceMesh`` or a mapping of axis sizes.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed.sharding import (_axis_sizes, _map_specs,
                                              _mesh_axis_size, make_decode_rules,
                                              make_train_rules, param_pspecs,
                                              placements_for)

__all__ = [
    "dp_axes", "batch_axis_for", "seq_axes_for", "cache_pspecs",
    "batch_pspecs", "cell_shardings", "state_pspecs", "tree_placements",
    "rules_for_cell",
]


def dp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _axis_size(mesh, axes) -> int:
    return _mesh_axis_size(_axis_sizes(mesh), axes)


def batch_axis_for(bsize: int, mesh, multi_pod: bool):
    """Largest dp prefix that divides the batch (fallback: replicate)."""
    for cand in (dp_axes(multi_pod), ("data",), None):
        if cand is None:
            return None
        if bsize % _axis_size(mesh, cand) == 0:
            return tuple(cand)
    return None


def seq_axes_for(seq: int, mesh, batch_sharded: bool):
    """Cache sequence placement: if batch is unshardable (long_500k B=1),
    spread the cache seq over everything that divides it."""
    cands = (("model",),) if batch_sharded else (("data", "model"), ("model",), ("data",))
    for cand in cands:
        if seq % _axis_size(mesh, cand) == 0:
            return tuple(cand)
    return None


def _dim(mesh, size: int, axis):
    """axis if it divides size else None."""
    if axis is None or size % _axis_size(mesh, axis) != 0:
        return None
    return axis


def _P(*axes) -> Tuple:
    """A spec in ``PartitionSpec``'s canonical form: a one-axis tuple is
    that axis's name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes)


def _keystr(path) -> str:
    """A tree path as ``jax.tree_util.keystr`` prints it (``[0]['k']``):
    the reference's rules match on that string."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in path)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return fn(_keystr(path), tree)


def cache_pspecs(caches, cfg: ModelConfig, cell: ShapeCell, mesh, multi_pod: bool):
    """Spec tree matching ``models.transformer.init_caches``'s output,
    rule for rule the reference's (which match the ``keystr`` path, so a
    ``['conv']`` leaf takes the 3-D rule, as there)."""
    b = cell.global_batch
    bax = batch_axis_for(b, mesh, multi_pod)

    def spec_for(path: str, leaf) -> Tuple:
        shape = leaf.shape
        if "cross" in path:                # (B, enc_frames, kv, dh)
            return _P(_dim(mesh, shape[0], bax), None, None, None)
        if path.endswith("conv"):          # mamba (B, k-1, d_inner)
            return _P(_dim(mesh, shape[0], bax), None, _dim(mesh, shape[2], "model"))
        if path.endswith("ssm"):           # mamba (B, d_inner, N)
            return _P(_dim(mesh, shape[0], bax), _dim(mesh, shape[1], "model"), None)
        if path.endswith("C"):             # mlstm (B, H, dk, dv)
            return _P(_dim(mesh, shape[0], bax), None, None, _dim(mesh, shape[3], "model"))
        if len(shape) == 4:                # attn KV cache (B, S_alloc, kv, dh)
            s_ax = seq_axes_for(shape[1], mesh, bax is not None)
            return _P(_dim(mesh, shape[0], bax), s_ax, None, None)
        if len(shape) == 3:                # mlstm n (B, H, dk)
            return _P(_dim(mesh, shape[0], bax), None, _dim(mesh, shape[2], "model"))
        if len(shape) == 2:                # slstm c/n/h/m (B, d) / mlstm m (B, H)
            return _P(_dim(mesh, shape[0], bax), _dim(mesh, shape[1], "model"))
        return _P(*([_dim(mesh, shape[0], bax)] + [None] * (len(shape) - 1)))

    return _map_with_path(spec_for, caches)


def batch_pspecs(batch, mesh, cell: ShapeCell, multi_pod: bool):
    bax = batch_axis_for(cell.global_batch, mesh, multi_pod)

    def spec(path, leaf):
        lead = _dim(mesh, leaf.shape[0], bax)
        return _P(*([lead] + [None] * (leaf.ndim - 1)))

    return _map_with_path(spec, batch)


def state_pspecs(state_shapes, mesh):
    """Specs for {"params", "opt", "step"(, "masks")}: opt moments and the
    master copy mirror their parameters; counters replicated; masks mirror
    their params where present."""
    pspec = param_pspecs(state_shapes["params"], mesh)
    out: Dict[str, Any] = {"params": pspec, "step": ()}
    opt = {"m": pspec, "v": pspec, "count": ()}
    if "master" in state_shapes["opt"]:
        opt["master"] = pspec
    out["opt"] = opt
    if "masks" in state_shapes:
        out["masks"] = _mask_specs(state_shapes["masks"], pspec)
    return out


def _mask_specs(masks, pspec):
    def walk(m, s):
        if isinstance(m, dict):
            return {k: walk(m[k], s.get(k) if isinstance(s, dict) else None) for k in m}
        if isinstance(m, list):
            return [walk(mm, s[i] if isinstance(s, list) else None) for i, mm in enumerate(m)]
        if m is None:
            return None
        return s if s is not None else ()

    return walk(masks, pspec)


def tree_placements(pspecs, mesh):
    """DTensor placements per leaf of a spec tree (a ``None`` spec
    replicated), the counterpart of the reference's ``tree_named``."""
    return _map_specs(lambda spec: placements_for(spec or (), mesh), pspecs)


def rules_for_cell(cell: ShapeCell, mesh, multi_pod: bool):
    if cell.kind == "decode":
        bax = batch_axis_for(cell.global_batch, mesh, multi_pod)
        return make_decode_rules(multi_pod, shard_cache_seq=bax is None)
    return make_train_rules(multi_pod)


def cell_shardings(cfg: ModelConfig, cell: ShapeCell, mesh, multi_pod: bool,
                   specs: Dict[str, Any], state_shapes=None):
    """Full spec bundle for one dry-run cell.

    specs: output of ``configs.input_specs``.  state_shapes: the train
    state (train cells) or ``{"params": ...}`` (anything with ``.shape``
    per leaf).  Returns a dict of spec trees."""
    out: Dict[str, Any] = {"batch": batch_pspecs(specs["batch"], mesh, cell, multi_pod)}
    if cell.kind == "train":
        if state_shapes is None:
            raise ValueError("cell_shardings: a train cell needs its state_shapes")
        out["state"] = state_pspecs(state_shapes, mesh)
    else:
        params_shapes = state_shapes["params"] if state_shapes and "params" in state_shapes \
            else state_shapes
        out["params"] = param_pspecs(params_shapes, mesh)
    if cell.kind == "decode":
        out["caches"] = cache_pspecs(specs["caches"], cfg, cell, mesh, multi_pod)
        out["cache_len"] = ()
    return out
