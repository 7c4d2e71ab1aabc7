"""Per-rank cost counter: the port's counterpart of XLA's per-device
``cost_analysis``, the collectives parsed from HLO text and
``memory_analysis``.

``CostCounter`` is a ``TorchDispatchMode``.  It steps aside for DTensor
ops (returning ``NotImplemented``), so DTensor runs its sharding
propagation and issues the **local** ops and collectives of this rank,
which the counter then sees.  It records:

* ``flops``: matmul and convolution FLOPs of the local ops, by
  ``torch.utils.flop_counter``'s formulas (composite ops without one are
  decomposed first, as ``FlopCounterMode`` does);
* ``bytes_accessed``: the bytes every local op reads and writes (each
  tensor input once, each tensor output once; views, metadata queries
  and collectives move nothing here).  The port runs op by op, unfused,
  so this is larger than XLA's count of a fused program;
* ``collectives``: every ``c10d_functional`` / ``c10d`` collective with
  its kind (the reference's names: "all-gather", "all-reduce",
  "reduce-scatter", "all-to-all"; "broadcast"), its per-rank result
  bytes, its group size and where it was issued (``origin``: the chain
  of ``repro_torch`` functions on the Python stack, or the autograd
  node for a backward op);
* ``peak_bytes``: the peak of live local tensor bytes during the count:
  the storages of ``live`` (the tensors the caller holds when it starts:
  state and inputs, DTensors by their local shards) plus every storage an
  op or a collective allocates, less each one freed (in-place ops and
  views allocate nothing).

It counts the same on real tensors and under ``FakeTensorMode`` (where
nothing is allocated), so a fake trace of a step and the real run of the
same step count alike.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["CostCounter", "Collective", "local_bytes"]

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd", "c10d")
_FREE = frozenset({"wait_tensor", "detach", "size", "sym_size", "stride",
                   "sym_stride", "numel", "sym_numel", "dim",
                   "is_contiguous", "storage_offset", "sym_storage_offset",
                   "lift_fresh", "_local_scalar_dense", "set_"})


@dataclasses.dataclass
class Collective:
    kind: str
    result_bytes: int       # per-rank result buffer bytes
    group_size: int
    origin: str


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree``, a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    return sum(_nbytes(t) for t in _local_tensors(tree))


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, str):                   # functional: group name
            from torch.distributed.distributed_c10d import _resolve_process_group
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError):
                continue
        if hasattr(a, "size") and not isinstance(a, (torch.Tensor, list)):
            try:                                 # c10d: a ProcessGroup
                return int(a.size())
            except (TypeError, RuntimeError):
                continue
    return 1


def _origin() -> str:
    """The ``repro_torch`` functions on the Python stack, outermost
    first, without the step builders and this package; in a backward
    pass without them, the autograd node being run."""
    names = []
    frame = sys._getframe(2)
    while frame is not None:
        mod = frame.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and not mod.startswith(
                "repro_torch.distributed"):
            names.append(f"{mod.rsplit('.', 1)[-1]}.{frame.f_code.co_name}")
        frame = frame.f_back
    if names:
        return "/".join(reversed(names))
    node = torch._C._current_autograd_node()
    return f"backward/{node.name()}" if node is not None else "?"


def _in_sharding_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs each new op once on fake global-shape arguments to learn its
    output's metadata: work no rank does."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        frame = frame.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts the local work of the code run under it (see the module
    docstring); ``with CostCounter(live=state) as c: ...``."""

    def __init__(self, *, live: Any = None, origins: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: List[Collective] = []
        self.ops = 0
        self._origins = origins
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: Dict[int, Any] = {}
        self._track(_local_tensors(live))
        self.baseline_bytes = self.live_bytes

    # -- memory ----------------------------------------------------------------

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self.live_bytes += n
            self._seen[key] = weakref.ref(st, self._freer(key, n))
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freer(self, key: int, n: int):
        def free(_):
            if self._seen.pop(key, None) is not None:
                self.live_bytes -= n
        return free

    # -- dispatch ----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            out = func(*args, **kwargs)
            if name in _KINDS:
                res = _tensors(args[0]) if ns == "c10d" else _tensors(out)
                self.collectives.append(Collective(
                    _KINDS[name], sum(_nbytes(t) for t in res),
                    _group_size(list(args) + list(kwargs.values())),
                    _origin() if self._origins else ""))
                if ns != "c10d":
                    self._track(out)
            return out
        if (ns != "aten" or name in _FREE or func.is_view
                or _in_sharding_propagation()):
            return func(*args, **kwargs)
        if packet not in self._flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.ops += 1
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](*args, **kwargs,
                                                          out_val=out))
        self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes_accessed += sum(_nbytes(t) for t in _tensors(out))
        if not func._schema.is_mutable:
            self._track(out)
        return out

    # -- summaries ---------------------------------------------------------------

    def collective_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for c in self.collectives:
            counts[c.kind] = counts.get(c.kind, 0) + 1
        return counts

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "ops": self.ops, "collectives": self.collective_counts(),
                "collective_bytes": sum(c.result_bytes for c in self.collectives),
                "peak_bytes": self.peak_bytes}
