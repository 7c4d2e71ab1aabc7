"""Runtime enforcement for the analyzer's two dynamic claims — the
counterpart of ``src/repro/analysis/runtime.py``: *steady-state decode
captures nothing new* and *one device->host transfer boundary per chunk
and one per admission*.

Three cooperating pieces:

* **Compile tracking** — in the port a "compile" is a CUDA-graph capture
  (``serving/graphs.py``) or a kernel library load
  (``kernels/_build.library``); both call :func:`count_compile`, and
  :func:`compile_events` is the process-wide count.  ``CompileTracker``
  snapshots per-object cache sizes (``obj._cache_size()``: a
  ``PackedGraphs``'s captured variants) beside that counter.
* **Sync regions** — ``sync_region(tag)`` declares an *intentional*
  blocking host round-trip (the engine wraps its one-per-chunk and
  one-per-admission transfers in one).  Regions are counted per tag.
* **Stray-pull interception** — ``no_host_sync()`` patches the tensor
  host-materialisation hooks (``item``, ``tolist``, ``numpy``, ``cpu``,
  ``__array__``, ``__bool__``, ``__int__``, ``__float__``,
  ``__index__``), ``to`` with a CPU target, ``copy_`` from a guarded
  tensor into a CPU one, the module entry points ``np.asarray`` and
  ``np.array`` (when a tensor is among the leaves) and
  ``torch.cuda.synchronize`` / ``Stream.synchronize`` /
  ``Event.synchronize``, so that any pull *outside* a declared region
  raises ``HostSyncError``.  A pull made inside another (``__array__``
  calling ``numpy``, ``np.asarray`` calling ``__array__``) counts once.

The **guarded device** is the device whose tensors count as device
values: the card by default.  The CPU tests pass the CPU, so that CPU
tensors stand for device values there, as JAX's CPU arrays do in the
reference's tests.  ``to`` and ``copy_`` count only when they cross to
the CPU from another device, so on the CPU ``x.to(q.device)`` and a
``copy_`` between two CPU tensors are no pulls (the port's plain paths
and caches use both in place); every other hook, ``cpu`` included,
counts on any guarded tensor.  On the
card ``no_host_sync`` also sets ``torch.cuda.set_sync_debug_mode("error")``, which catches the syncs no
Python hook sees (a blocking copy, a data-dependent shape), and
``sync_region`` restores the previous mode inside the region — the
counterpart of ``jax.transfer_guard_device_to_host``, which likewise
only enforces on an accelerator.

All counters are process-global; the engine keeps its own per-instance
region counts for ``analysis_stats()``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

__all__ = [
    "HostSyncError", "sync_region", "no_host_sync", "measure_pulls",
    "region_counts", "pull_counts", "reset_counters", "CompileTracker",
    "cache_size", "compile_events", "count_compile",
]


class HostSyncError(RuntimeError):
    """A device->host pull happened outside any declared sync_region."""


# ---------------------------------------------------------------------------
# Compile-event counter (process-wide tripwire)
# ---------------------------------------------------------------------------

_compile_events = 0


def count_compile() -> None:
    """Record one graph capture or kernel library load."""
    global _compile_events
    _compile_events += 1


def compile_events() -> int:
    """Process-wide count of graph captures and kernel library loads."""
    return _compile_events


def cache_size(fn: Any) -> int:
    """Captured variants held by ``fn`` (``fn._cache_size()``; -1 where
    nothing is cached, as for a function that runs eagerly)."""
    try:
        return int(fn._cache_size())
    except Exception:
        return -1


class CompileTracker:
    """Snapshot/diff cache sizes for a set of tracked objects."""

    def __init__(self, **fns: Any) -> None:
        self._fns = dict(fns)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "events": compile_events(),
            "caches": {name: cache_size(fn) for name, fn in self._fns.items()},
        }

    @staticmethod
    def new_compiles(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, int]:
        """Per-object cache growth between two snapshots (+ event delta)."""
        out = {
            name: after["caches"].get(name, -1) - size
            for name, size in before["caches"].items()
        }
        out["_events"] = after["events"] - before["events"]
        return out


# ---------------------------------------------------------------------------
# Sync regions + stray-pull interception
# ---------------------------------------------------------------------------

_lock = threading.RLock()
_region_stack: List[str] = []
_region_counts: Dict[str, int] = {}
_pull_counts: Dict[str, int] = {}
_strict_depth = 0
_guarded: List[str] = []            # device types of the active meters
_saved: List[Tuple[Any, str, bool, Any]] = []   # (owner, attr, owned, value)
_sync_modes: List[int] = []         # sync-debug modes saved by no_host_sync
_in_pull = threading.local()

_TENSOR_HOOKS = ("item", "tolist", "numpy", "cpu", "__array__", "__bool__",
                 "__int__", "__float__", "__index__")


def _device_type(dev: Any) -> str:
    if dev is None:
        return "cuda"
    return torch.device(dev).type


def _is_guarded(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type in _guarded


def _to_cpu_target(args: Tuple, kwargs: Dict) -> bool:
    """Does a `Tensor.to(...)` call name the CPU as its target?"""
    cands = list(args) + [kwargs.get("device"), kwargs.get("other")]
    for a in cands:
        if isinstance(a, torch.Tensor):
            if a.device.type == "cpu":
                return True
        elif isinstance(a, (str, torch.device)):
            try:
                if torch.device(a).type == "cpu":
                    return True
            except (RuntimeError, TypeError):
                pass
    return False


def _record_pull(hook: str) -> None:
    tag = _region_stack[-1] if _region_stack else None
    if tag is None and _strict_depth > 0:
        raise HostSyncError(
            f"device->host pull via `{hook}` outside any sync_region while "
            f"no_host_sync() is active — wrap the pull in "
            f"repro_torch.analysis.runtime.sync_region(tag) or remove it")
    key = tag if tag is not None else "<untagged>"
    _pull_counts[key] = _pull_counts.get(key, 0) + 1


def _metered(orig: Callable, hook: str, is_pull: Callable[..., bool]) -> Callable:
    """Wrap ``orig`` so that an outermost call for which ``is_pull(*args,
    **kwargs)`` holds is recorded; nested pulls count once."""
    @functools.wraps(orig)
    def wrapper(*args: Any, **kwargs: Any):
        if getattr(_in_pull, "depth", 0) or not is_pull(*args, **kwargs):
            return orig(*args, **kwargs)
        _record_pull(hook)
        _in_pull.depth = 1
        try:
            return orig(*args, **kwargs)
        finally:
            _in_pull.depth = 0

    return wrapper


def _has_tensor_leaf(obj: Any, depth: int = 0) -> bool:
    if _is_guarded(obj):
        return True
    if depth < 4 and isinstance(obj, (list, tuple)):
        return any(_has_tensor_leaf(o, depth + 1) for o in obj)
    if depth < 4 and isinstance(obj, dict):
        return any(_has_tensor_leaf(o, depth + 1) for o in obj.values())
    return False


def _patch(owner: Any, attr: str, wrapper: Callable) -> None:
    owned = attr in vars(owner)
    _saved.append((owner, attr, owned, vars(owner).get(attr)))
    setattr(owner, attr, wrapper)


def _hooks() -> List[Tuple[Any, str, str, Callable[..., bool]]]:
    """(owner, attribute, label, is_pull) of every patched entry point."""
    def self_guarded(self, *a, **k):
        return _is_guarded(self)

    def leaves_device(self, *a, **k):
        return _is_guarded(self) and self.device.type != "cpu"

    def copy_pull(self, *a, **k):
        src = a[0] if a else k.get("src")
        return self.device.type == "cpu" and leaves_device(src)

    out = [(torch.Tensor, name, f"Tensor.{name}", self_guarded)
           for name in _TENSOR_HOOKS]
    out.append((torch.Tensor, "to", "Tensor.to",
                lambda self, *a, **k: leaves_device(self) and _to_cpu_target(a, k)))
    out.append((torch.Tensor, "copy_", "Tensor.copy_", copy_pull))
    for label, attr in (("np.asarray", "asarray"), ("np.array", "array")):
        out.append((np, attr, label, lambda *a, **k: _has_tensor_leaf(a)))
    if "cuda" in _guarded:
        out.append((torch.cuda, "synchronize", "torch.cuda.synchronize",
                    lambda *a, **k: True))
        out.append((torch.cuda.Stream, "synchronize", "Stream.synchronize",
                    lambda *a, **k: True))
        out.append((torch.cuda.Event, "synchronize", "Event.synchronize",
                    lambda *a, **k: True))
    return out


def _activate_meter(device_type: str) -> None:
    with _lock:
        _guarded.append(device_type)
        if len(_guarded) > 1:
            if device_type == "cuda" and "cuda" not in _guarded[:-1]:
                _deactivate_patches()      # re-patch with the card's hooks
                _install_patches()
            return
        _install_patches()


def _install_patches() -> None:
    for owner, attr, label, is_pull in _hooks():
        _patch(owner, attr, _metered(getattr(owner, attr), label, is_pull))


def _deactivate_patches() -> None:
    while _saved:
        owner, attr, owned, value = _saved.pop()
        if owned:
            setattr(owner, attr, value)
        else:
            delattr(owner, attr)


def _deactivate_meter() -> None:
    with _lock:
        gone = _guarded.pop()
        if not _guarded:
            _deactivate_patches()
        elif gone == "cuda" and "cuda" not in _guarded:
            _deactivate_patches()
            _install_patches()


@contextlib.contextmanager
def sync_region(tag: str) -> Iterator[None]:
    """Declare one intentional blocking host round-trip.

    Counted per tag; inside the region host pulls are allowed (and
    counted when a meter is active), and on the card the sync-debug mode
    that ``no_host_sync`` set is lifted for the region.
    """
    _region_counts[tag] = _region_counts.get(tag, 0) + 1
    _region_stack.append(tag)
    lifted = bool(_sync_modes)
    if lifted:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(_sync_modes[0])
    try:
        yield
    finally:
        if lifted:
            torch.cuda.set_sync_debug_mode(prev)
        _region_stack.pop()


@contextlib.contextmanager
def no_host_sync(strict: bool = True, device: Any = None) -> Iterator[None]:
    """Forbid device->host pulls of ``device``'s tensors (default: the
    card) outside declared sync_regions.

    ``strict=True`` raises ``HostSyncError`` on the first stray pull;
    ``strict=False`` only counts them (under the "<untagged>" tag).  On
    the card it also turns CUDA's sync-debug mode to "error" until the
    block ends.
    """
    global _strict_depth
    dtype = _device_type(device)
    _activate_meter(dtype)
    card = dtype == "cuda"
    if card:
        _sync_modes.append(torch.cuda.get_sync_debug_mode())
        torch.cuda.set_sync_debug_mode("error")
    if strict:
        _strict_depth += 1
    try:
        yield
    finally:
        if strict:
            _strict_depth -= 1
        if card:
            torch.cuda.set_sync_debug_mode(_sync_modes.pop())
        _deactivate_meter()


@contextlib.contextmanager
def measure_pulls(device: Any = None) -> Iterator[Dict[str, int]]:
    """Count host pulls of ``device``'s tensors (default: the card) per
    region tag without forbidding anything."""
    start = dict(_pull_counts)
    _activate_meter(_device_type(device))
    try:
        delta: Dict[str, int] = {}
        yield delta
    finally:
        _deactivate_meter()
        for k, v in _pull_counts.items():
            d = v - start.get(k, 0)
            if d:
                delta[k] = d


def region_counts() -> Dict[str, int]:
    return dict(_region_counts)


def pull_counts() -> Dict[str, int]:
    return dict(_pull_counts)


def reset_counters() -> None:
    _region_counts.clear()
    _pull_counts.clear()

