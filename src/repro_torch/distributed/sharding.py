"""Logical-axis rules, the device mesh and per-param axis specs — torch
port of ``src/repro/distributed/sharding.py``.

Models name their dims logically ("batch", "seq", "embed", "heads",
"mlp", "experts", "vocab", "kv_seq").  A launcher installs a rule set
mapping logical names to mesh axes (``axis_rules``) and a mesh
(``use_mesh``); outside those contexts the model code runs on one device
as it always did.  The one consumer in the port is the expert-parallel
MoE (``models/moe_alltoall.py``), which runs when a mesh with a "model"
axis and a rule set are both installed, as in the reference.

What differs from the reference, by design:

* the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over one
  process per device (``make_mesh``), and the per-rank code runs its
  collectives explicitly on the mesh's per-axis process groups.  GSPMD's
  hooks have nothing to hint here: ``logical_constraint`` (a sharding
  constraint for XLA's partitioner) and ``shard_map`` (per-shard code
  over global arrays) have no counterpart, since PyTorch has no
  partitioner and every rank already runs the per-shard code;
* ``param_pspecs`` returns each leaf's spec as a plain tuple of axis
  names per dim (``None``, a name, or a tuple of names), for a mapping of
  axis sizes or a ``DeviceMesh``; ``named_sharding_tree`` (specs to XLA
  shardings) and ``cost_analysis`` (XLA's compiled-cost dict) belong to
  the dry-run, which is not ported yet.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

__all__ = [
    "axis_rules",
    "current_rules",
    "make_train_rules",
    "make_decode_rules",
    "make_mesh",
    "use_mesh",
    "current_mesh",
    "param_pspecs",
]

AxisVal = Union[None, str, Tuple[str, ...]]

_RULES: contextvars.ContextVar[Optional[Dict[str, AxisVal]]] = contextvars.ContextVar(
    "repro_torch_axis_rules", default=None)
_MESH: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def axis_rules(rules: Optional[Mapping[str, AxisVal]]):
    token = _RULES.set(dict(rules) if rules is not None else None)
    try:
        yield
    finally:
        _RULES.reset(token)


def current_rules() -> Optional[Dict[str, AxisVal]]:
    return _RULES.get()


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    process group (rank r at the row-major coordinate of r).  A "cuda"
    mesh unless the caller asks for "cpu"; without a card a "cuda" mesh
    raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for a cuda mesh; pass "
            "device_type='cpu' for a mesh of CPU ranks (gloo)")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh (``current_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def make_train_rules(multi_pod: bool) -> Dict[str, AxisVal]:
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv": None,
        "mlp": "model",
        "experts": "model",   # EP weights (only when cfg.moe_ep)
        "expert_cap": "model", # MoE dispatch-buffer capacity dim
        "vocab": "model",
        "kv_seq": None,       # training: KV not sharded on seq
        "res_seq": "model",   # used only when cfg.seq_sharded_acts (SP)
        "fsdp": "data",
        "tp": "model",
    }


def make_decode_rules(multi_pod: bool, *, shard_cache_seq: bool) -> Dict[str, AxisVal]:
    """Decode: small batches; optionally context-parallel KV cache."""
    rules = make_train_rules(multi_pod)
    if shard_cache_seq:
        # batch=1 long-context: batch unshardable, cache seq over data
        rules["batch"] = None
        rules["kv_seq"] = "data"
        rules["seq"] = None
    else:
        rules["kv_seq"] = None
    return rules


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping of sizes."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    return {name: int(mesh.size(i)) for i, name in enumerate(names)}


def _mesh_axis_size(sizes: Mapping[str, int], axis: AxisVal) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return sizes[axis]
    return math.prod(sizes[a] for a in axis)


def _spec(shape, sizes: Mapping[str, int], *axes: AxisVal) -> Tuple[AxisVal, ...]:
    """Per-dim axes, a dim that does not divide its axes' size replicated."""
    fixed = []
    for dim, axis in enumerate(axes):
        if axis is not None and shape[dim] % _mesh_axis_size(sizes, axis) != 0:
            axis = None
        fixed.append(axis)
    return tuple(fixed)


def param_pspecs(shapes: Mapping[str, Any], mesh, *, fsdp_axis: str = "data",
                 tp_axis: str = "model"):
    """Spec tree (a tuple of axes per dim) for a params tree of anything
    with ``.shape``, over ``mesh`` (a ``DeviceMesh`` or a mapping of
    axis sizes).

    Patterns (matched on the '/'-joined path, first match wins):
      embedding (V, D)                   -> (tp, fsdp)     vocab-parallel
      attn q/o, mlp in/out, generic 2-D  -> col/row TP + FSDP
      moe experts (E, D, F)              -> FSDP if E divides tp, else
                                             intra-expert TP
      1-D (norm scales, biases)          -> replicated
    """
    d, t = fsdp_axis, tp_axis
    sizes = _axis_sizes(mesh)

    def rule(path: str, shape: Tuple[int, ...]) -> Tuple[AxisVal, ...]:
        n = len(shape)
        pl = path.lower()
        if n <= 1:
            return ()
        if re.search(r"(embed|tok_embeddings|lm_head|unembed)", pl):
            return _spec(shape, sizes, t, d)
        if n == 3 and re.search(r"(expert|moe)", pl):
            e = shape[0]
            if e % _mesh_axis_size(sizes, t) != 0 or shape[1] * shape[2] >= 16_000_000:
                if re.search(r"(w_down|down|wo)", pl):
                    return _spec(shape, sizes, None, t, d)   # (E, F, D)
                return _spec(shape, sizes, None, d, t)       # (E, D, F)
            return _spec(shape, sizes, None, d, None)        # FSDP only
        if n == 2:
            if re.search(r"(wo|out_proj|o_proj|down|w2|dense_4h|proj_out)", pl):
                return _spec(shape, sizes, t, d)             # row-parallel
            return _spec(shape, sizes, d, t)                 # col-parallel
        if n == 3:
            # fused qkv (D, H, dh) or conv (kw, cin, cout)
            return _spec(shape, sizes, d, t, None)
        return _spec(shape, sizes, *([None] * (n - 2)), d, t)

    def walk(node, prefix):
        if isinstance(node, Mapping):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, f"{prefix}/{i}") for i, v in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        if node is None:
            return None
        return rule(prefix, tuple(node.shape))

    return walk(shapes, "")
