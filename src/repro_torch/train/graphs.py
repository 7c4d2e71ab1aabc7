"""The graphed train step — the counterpart of the reference's
``jax.jit(make_train_step(...))`` (``src/repro/launch/train.py:53`` and
``:96``): one CUDA graph of ``train_step.make_train_body``'s in-place
step per variant, run with the reference's functional contract.

A :class:`GraphedTrainStep` is a callable ``(state, batch) -> (state,
metrics)`` like ``make_train_step``'s.  It owns one static state and one
static batch per variant: the layout of the state tree (each leaf's path,
shape and dtype, so masks or none) together with the batch's, as the
reference's jit keeps one program per argument shape.  A call

1. copies the input state and the batch into the variant's static
   tensors;
2. on a variant's first call, captures the body with
   ``serving.graphs.capture`` (its warm-up run on a side stream is this
   call's step, and the record pass runs nothing); later calls replay it;
3. clones the static state and the metrics out into fresh tensors, and
   returns them (the masks are the caller's own, as the eager step
   returns them).

No argument is donated (the reference passes no ``donate_argnums``): the
caller's state is never written and a result is never overwritten by a
later call, so a trainer may checkpoint its state asynchronously and a
caller may step twice from one state.  The price is a copy of the state
in and a clone out per call.  Steps 1–3 of a replay run under
``torch.cuda.set_sync_debug_mode("error")``, so a hidden host sync
raises; so does a batch on the host (the step takes device batches, as
``data.LMPipeline`` makes them).  Any failure to capture or replay
raises ``GraphFailure``: nothing falls back to the eager step.  A
capture counts in ``analysis.runtime.compile_events``; kernel launches
are counted per replay (``Captured.replay``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.masks import copy_tree_, map_tree
from repro_torch.core.structures import iter_leaves
from repro_torch.serving.graphs import (
    Captured,
    GraphFailure,
    _sync_debug_error,
    capture,
    pool_reserved_bytes,
)

__all__ = ["GraphedTrainStep", "clone_tree", "train_step_for"]


def clone_tree(tree):
    """Fresh tensors with ``tree``'s values, allocated first and then
    filled by one batched copy (``None`` leaves stay ``None``)."""
    out = map_tree(lambda t: None if t is None else torch.empty_like(t), tree)
    copy_tree_(out, tree)
    return out


def _layout(tree) -> Tuple:
    return tuple((path, tuple(t.shape), t.dtype, t.device)
                 for path, t in iter_leaves(tree))


def _nbytes(tree) -> int:
    return sum(t.nbytes for _, t in iter_leaves(tree))


@dataclasses.dataclass
class _Variant:
    graph: Captured
    state: Dict[str, Any]           # static: the body's state, in place
    batch: Dict[str, torch.Tensor]  # static
    copy_bytes: int                 # copied in and out by one call


class GraphedTrainStep:
    """``body(state, batch) -> metrics`` (in place, e.g.
    ``make_train_body``) as a functional step ``(state, batch) ->
    (state, metrics)`` replayed from one CUDA graph per variant on
    ``device``, which must be a CUDA device.  All variants share one
    memory pool."""

    def __init__(self, body: Callable[[Dict[str, Any], Dict[str, torch.Tensor]],
                                      Dict[str, torch.Tensor]],
                 device, *, what: str = "train step"):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.body, self.device, self.what = body, device, what
        self.pool = torch.cuda.graph_pool_handle()
        self.variants: Dict[Tuple, _Variant] = {}

    def __call__(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        with tracing.span("train.step"):
            return self._step(state, batch)

    def _step(self, state, batch):
        key = (_layout(state), _layout(batch))
        v = self.variants.get(key)
        if v is None:
            return self._capture(key, state, batch)
        tracing.count("train.copy_bytes", v.copy_bytes)
        try:
            with _sync_debug_error():
                with tracing.span("train.copy_in"):
                    copy_tree_(v.state, state)
                    copy_tree_(v.batch, batch)
                with tracing.span("train.replay"):
                    metrics = v.graph.replay()
                with tracing.span("train.copy_out"):
                    return self._result(v.state, state), clone_tree(metrics)
        except RuntimeError as err:
            raise GraphFailure(f"replay of {self.what} failed: {err}") from err

    def _capture(self, key: Tuple, state, batch):
        elsewhere = {str(dev) for layout in key for *_, dev in layout} - {str(self.device)}
        if elsewhere:
            raise GraphFailure(f"{self.what} runs on {self.device}: its state "
                               f"and batch hold tensors on {sorted(elsewhere)}")
        try:
            static_state, static_batch = clone_tree(state), clone_tree(batch)
        except RuntimeError as err:
            raise GraphFailure(f"capture of {self.what} failed: {err}") from err
        first, graph = capture(lambda: self.body(static_state, static_batch),
                               self.device, self.pool,
                               f"{self.what} variant {len(self.variants)}")
        # a replay copies the state and batch in, and the state less its
        # masks and the metrics out
        copied = (2 * _nbytes(static_state) + _nbytes(static_batch)
                  - _nbytes(state.get("masks")) + _nbytes(graph.out))
        self.variants[key] = _Variant(graph, static_state, static_batch, copied)
        tracing.count("train.copy_bytes", copied)
        return self._result(static_state, state), first

    @staticmethod
    def _result(static_state: Dict[str, Any], state: Dict[str, Any]):
        out = clone_tree({k: v for k, v in static_state.items() if k != "masks"})
        if "masks" in state:
            out["masks"] = state["masks"]
        return out

    def pool_bytes(self) -> Optional[int]:
        """Bytes the graphs' memory pool holds (``pool_reserved_bytes``)."""
        return pool_reserved_bytes(self.pool, self.device)

    def stats(self) -> Dict[str, object]:
        """Captures, each one's seconds (warm-up run included) and their
        split summed, replays and kernel launches per replay, in the
        order the variants were captured."""
        rows = [v.graph for v in self.variants.values()]
        return {
            "captures": len(rows),
            "capture_seconds": [g.capture_seconds for g in rows],
            "capture_split": {part: sum(g.split.get(part, 0.0) for g in rows)
                              for part in ("warm_up", "record", "sync")},
            "replays": [g.replays for g in rows],
            "launches_per_replay": [dict(g.launches) for g in rows],
        }


def train_step_for(cfg, opt_cfg, lr_schedule, device, *, mesh=None,
                   what: str = "train step") -> Callable:
    """The train step the launchers and examples run, the counterpart of
    the reference's ``jax.jit(make_train_step(...))``: graphed on a CUDA
    device without a mesh (``GraphedTrainStep(make_train_body(...))``),
    else the eager ``make_train_step`` (on the CPU because the caller
    asked for it; under a mesh because a captured DTensor step is not
    supported)."""
    from .train_step import make_train_body, make_train_step
    if torch.device(device).type == "cuda" and mesh is None:
        return GraphedTrainStep(make_train_body(cfg, opt_cfg, lr_schedule),
                                device, what=what)
    return make_train_step(cfg, opt_cfg, lr_schedule)
