"""Logical-axis rules, the device mesh, per-param axis specs and their
DTensor placements — torch port of ``src/repro/distributed/sharding.py``.

Models name their dims logically ("batch", "seq", "embed", "heads",
"mlp", "experts", "vocab", "kv_seq").  A launcher installs a rule set
mapping logical names to mesh axes (``axis_rules``) and a mesh
(``use_mesh``); outside those contexts the model code runs on one device
as it always did.

DTensor (``torch.distributed.tensor``) is the port's counterpart of
GSPMD:

===========================================  =================================
reference (JAX)                              port
===========================================  =================================
``PartitionSpec`` tree -> ``NamedSharding``  spec tuple tree (``param_pspecs``)
                                             -> DTensor placements per mesh
                                             dim, ``Shard(d)`` / ``Replicate()``
                                             (``placements_for``,
                                             ``named_sharding_tree``,
                                             ``distribute_tree``)
``logical_constraint`` (a sharding           ``x.redistribute`` to the rules'
constraint for XLA's partitioner)            placements; a no-op unless ``x``
                                             is a DTensor and a mesh and rules
                                             are installed, so single-device
                                             paths run exactly as before
``shard_map`` (per-shard code)               ``shard_map`` here: DTensor's
                                             ``local_map`` around code DTensor
                                             has no strategy for
``cost_analysis(compiled)``                  ``cost_analysis(record)`` of the
                                             per-rank counter
                                             (``distributed/cost.py``)
===========================================  =================================

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over one
process per device (``make_mesh``).  The expert-parallel MoE
(``models/moe_alltoall.py``) stays per-rank code with explicit
collectives on the mesh's per-axis process groups.  ``param_pspecs``
returns each leaf's spec as a plain tuple of axis names per dim
(``None``, a name, or a tuple of names), for a mapping of axis sizes or a
``DeviceMesh``.
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
    "placements_for",
    "named_sharding_tree",
    "distribute_tree",
    "gather_tree",
    "is_dtensor",
    "gather_fsdp",
    "whole_groups",
    "batch_placements",
    "reduce_partial",
    "grad_as_input",
    "logical_constraint",
    "shard_map",
    "shard_extent",
    "cost_analysis",
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


# ---------------------------------------------------------------------------
# DTensor placements (the counterpart of NamedSharding)
# ---------------------------------------------------------------------------

def _axes_of(axis: AxisVal) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def placements_for(spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements, one per mesh dim, of a spec tuple (``None``, an
    axis name or a tuple of names per tensor dim; ``None`` or ``()``:
    replicated).  A tensor dim over several axes is sharded over each, the
    first major, as ``PartitionSpec(("pod", "data"))`` is."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, axis in enumerate(spec or ()):
        for a in _axes_of(axis):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def _is_spec(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x))


def _map_specs(fn, specs):
    """``fn`` over every spec tuple (or None) of a spec tree."""
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, Mapping):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return [_map_specs(fn, v) for v in specs]


def named_sharding_tree(pspecs, mesh):
    """The spec tree as a tree of placement tuples over ``mesh`` (``None``
    stays ``None``), the counterpart of the reference's tree of
    ``NamedSharding``."""
    return _map_specs(
        lambda s: None if s is None else placements_for(s, mesh), pspecs)


def distribute_tree(tree, specs, mesh):
    """Every tensor leaf of ``tree`` as a DTensor placed by its spec
    (``specs``: a spec tree of the same structure, a ``None`` spec
    replicated).  Every rank holds the same full tensor here (seeded
    init, a checkpoint read from disk), so each keeps its own shard and
    nothing is sent (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.masks import map_tree

    def place(t, spec):
        if t is None:
            return None
        return distribute_tensor(t, mesh, placements_for(spec, mesh),
                                 src_data_rank=None)

    return map_tree(place, tree, specs)


def gather_tree(tree):
    """Every DTensor leaf gathered to its full tensor (plain leaves as they
    are)."""
    from repro_torch.core.masks import map_tree

    return map_tree(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


_DTENSOR: Optional[type] = None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a sharded or replicated global
    tensor).  The single-device paths ask this at every sharding site,
    so the class is looked up once and the check is a bare
    ``isinstance``."""
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def logical_constraint(x, *logical_axes: Optional[str]):
    """Redistribute the DTensor ``x`` to the placements the installed rules
    give its logical dims (a dim named ``None``, or whose size does not
    divide its axes' size, replicated), as the reference's
    ``with_sharding_constraint`` pins GSPMD.  A no-op when ``x`` is a
    plain tensor or no mesh or rules are installed."""
    rules = _RULES.get()
    if rules is None or _MESH.get() is None or not is_dtensor(x):
        return x
    sizes = _axis_sizes(x.device_mesh)
    spec = []
    for dim, name in enumerate(logical_axes):
        axis = rules.get(name) if name is not None else None
        if axis is not None and x.shape[dim] % _mesh_axis_size(sizes, axis) != 0:
            axis = None
        spec.append(axis)
    want = placements_for(tuple(spec), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gather_fsdp(w):
    """The DTensor weight ``w`` gathered over the rules' "fsdp" axes
    (ZeRO-3: a parameter sharded over the data-parallel ranks is gathered
    before each use; the gather's backward reduce-scatters its gradient),
    its tensor-parallel sharding kept.  Anything else is returned as it
    is."""
    rules = _RULES.get()
    if not is_dtensor(w) or rules is None or rules.get("fsdp") is None:
        return w
    from torch.distributed.tensor import Replicate

    names = tuple(w.device_mesh.mesh_dim_names)
    fsdp = _axes_of(rules["fsdp"])
    want = tuple(Replicate() if names[i] in fsdp else pl
                 for i, pl in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def reduce_partial(x):
    """A DTensor with partial sums (a row-parallel product, a sum over a
    sharded dim) reduced to replicated, as an op autograd sees, so its
    gradient comes back replicated; anything else as it is.  Left to
    DTensor, the reduction happens inside the next op and the gradient
    comes back partial, which steers the backward products to
    strategies that repeat work on every rank."""
    if not is_dtensor(x) or not any(pl.is_partial() for pl in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, tuple(
        Replicate() if pl.is_partial() else pl for pl in x.placements))


class _GradAsInput(torch.autograd.Function):
    """Identity forward; the gradient placed as the input backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_as_input(x):
    """``x`` unchanged, but the gradient that comes back through it is
    placed as ``x`` is: at the input of a column-parallel product the
    gradient is a partial sum over the tensor-parallel ranks, reduced
    here (the all-reduce of Megatron's "f"); a gradient sharded where
    ``x`` is whole is gathered.  Left to DTensor, the partial sums flow
    on and steer later backward products to strategies that repeat work
    on every rank.  Plain tensors are returned as they are."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _GradAsInput.apply(x)


def whole_groups(x, dim: int, groups: int):
    """The DTensor ``x`` ready to split ``dim`` into ``groups`` (heads): the
    dim gathered over every mesh dim whose size does not divide
    ``groups``, so each shard holds whole groups.  Anything else is
    returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if pl.is_shard(dim % x.ndim) and groups % x.device_mesh.size(i)
                 else pl for i, pl in enumerate(x.placements))
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def batch_placements(x):
    """``x``'s placements with only its batch (dim 0) sharding kept, or
    ``None`` for a plain tensor."""
    if not is_dtensor(x):
        return None
    from torch.distributed.tensor import Replicate, Shard
    return tuple(pl if pl == Shard(0) else Replicate() for pl in x.placements)


def shard_map(fn, *, in_placements, out_placements, in_grad_placements=None):
    """``fn`` run on each rank's local shards: the counterpart of the
    reference's ``shard_map``, through DTensor's ``local_map`` over the
    installed mesh.  DTensor inputs are redistributed to
    ``in_placements`` first; plain tensor inputs count as replicated (the
    same on every rank) and are sliced to them.  ``in_grad_placements``
    says how each input's local gradient adds up (``Partial()`` where a
    replicated input's gradient is a partial sum over that mesh dim).
    Without a mesh, or with no DTensor input, it is ``fn`` itself."""
    def call(*args):
        mesh = _MESH.get()
        if mesh is None or not any(is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor.experimental import local_map

        rep = [Replicate()] * mesh.ndim
        args = [DTensor.from_local(a, mesh, rep, run_check=False)
                if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
                for a in args]
        return local_map(fn, out_placements=_as_lists(out_placements),
                         in_placements=_as_lists(in_placements),
                         in_grad_placements=_as_lists(in_grad_placements),
                         device_mesh=mesh, redistribute_inputs=True)(*args)
    return call


def _as_lists(placements):
    """``local_map``'s form: one output's (or input's) placements as a
    list, several as a tuple of lists (``None`` kept)."""
    from torch.distributed.tensor import Placement

    if placements is None:
        return None
    if all(isinstance(p, Placement) for p in placements):
        return list(placements)
    return tuple(None if p is None else list(p) for p in placements)


def shard_extent(x, dim: int) -> Tuple[int, int]:
    """(global index of this rank's first element, local size) along
    ``dim`` of the DTensor ``x`` (shards as ``torch.chunk`` cuts them, the
    mesh dims in order); (0, size) for a plain tensor."""
    size = int(x.shape[dim])
    if not is_dtensor(x):
        return 0, size
    coord = x.device_mesh.get_coordinate()
    off = 0
    for i, pl in enumerate(x.placements):
        if pl.is_shard() and pl.dim % x.ndim == dim % x.ndim:
            step = -(-size // x.device_mesh.size(i))
            start = min(coord[i] * step, size)
            off += start
            size = min(step, size - start)
    return off, size


def cost_analysis(record) -> Dict[str, Any]:
    """The per-rank counter's totals under XLA's ``cost_analysis`` keys:
    ``"flops"`` (matmul and convolution FLOPs of the local ops) and
    ``"bytes accessed"`` (bytes each local op reads and writes).
    ``record``: a ``distributed.cost.CostCounter``."""
    return {"flops": float(record.flops),
            "bytes accessed": float(record.bytes_accessed)}
