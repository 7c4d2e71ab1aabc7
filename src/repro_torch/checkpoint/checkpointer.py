"""Checkpointing: atomic and asynchronous, torch port of
``src/repro/checkpoint/checkpointer.py``.

Layout per step::

    <dir>/step_<n>.tmp/            (write in progress)
    <dir>/step_<n>/
        meta.json                  paths, shapes, dtypes, step
        leaf_00000.npy ...         one file per tree leaf (host numpy)
        COMMITTED                  commit marker (written last)

Contract:

* writes go to a ``.tmp`` dir, the commit marker is written, then the
  dir is renamed atomically, so a crash mid-save never corrupts the
  latest checkpoint and ``latest_step`` only returns committed steps;
* ``save_async`` copies the leaves to the host, then writes on a worker
  thread, so the training loop waits only for the device-to-host copy;
* ``keep`` bounds disk use (the oldest committed steps are removed);
* ``restore`` puts every leaf on the device of the matching leaf of
  ``target`` and checks its dtype;
* sharded state: a state of DTensors is saved as full tensors, and
  ``restore(..., specs=, mesh=)`` places them on ``mesh`` by a spec
  tree, which may be another mesh than the one that saved them, as the
  reference's ``restore(shardings=)`` (:124-160); without specs a
  DTensor leaf of ``target`` gets its own placements back.  Such a
  ``save`` is collective: every rank of the process group calls it
  (each takes part in the gathers), rank 0 alone writes, and the next
  ``wait`` (which ``save`` itself starts with) is a barrier, so every
  rank then sees the same committed steps.  A state that mixes DTensors
  with plain tensors is refused: its plain leaves may differ from rank
  to rank (expert shards under the all-to-all), and rank 0's alone
  would be kept.  A state of plain tensors is saved by each process
  that calls ``save``, as on one device.

The reference writes its meta with msgpack; here it is JSON (no
dependency beyond the standard library).  numpy has no bfloat16, so a
bf16 leaf is stored as its 16 bits (``int16``) with ``"bfloat16"`` as
its dtype in the meta, and read back bit for bit.  Leaves are taken in
the reference's pytree order (dict keys sorted, lists in order; ``None``
is no leaf).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.structures import iter_leaves

__all__ = ["Checkpointer"]

_BITS_AS = {torch.bfloat16: torch.int16}


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if _is_dtensor(t):                         # the whole tensor
        t = t.full_tensor()
    if t.dtype in _BITS_AS:
        t = t.view(_BITS_AS[t.dtype])
    return t.cpu().numpy()


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _is_dtensor(t) -> bool:
    return hasattr(t, "full_tensor")


def _collective(pairs) -> bool:
    """Whether saving the leaves ``pairs`` is collective (every leaf a
    DTensor); raises on a mix of DTensors and plain tensors."""
    sharded = [p for p, t in pairs if _is_dtensor(t)]
    if sharded and len(sharded) != len(pairs):
        plain = [p for p, t in pairs if not _is_dtensor(t)]
        raise ValueError(
            "a state that mixes DTensors with plain tensors cannot be saved: "
            f"the plain leaves ({', '.join(plain[:3])}, ...) may differ from "
            "rank to rank; place every leaf on the mesh")
    return bool(sharded)


def _rebuild(target: Any, by_path: Dict[str, torch.Tensor], prefix: str = ""):
    """``target``'s structure with each leaf replaced by ``by_path`` under
    the path ``iter_leaves`` gives it."""
    if isinstance(target, dict):
        return {k: _rebuild(v, by_path, f"{prefix}{k}/") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        out = [_rebuild(v, by_path, f"{prefix}{i}/") for i, v in enumerate(target)]
        return out if isinstance(target, list) else tuple(out)
    if target is None:
        return None
    return by_path[prefix[:-1]]


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._barrier = False       # the last save was collective

    # -- inspection ----------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def committed_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(full, "COMMITTED")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, state: Any, *, blocking: bool = True) -> None:
        # serialize with any in-flight async save: two writers racing on
        # the same step dir turn rmtree/makedirs into FileExists/NotFound
        self.wait()
        pairs = list(iter_leaves(state))
        collective = _collective(pairs)
        paths = [p for p, _ in pairs]
        dtypes = [_dtype_name(t) for _, t in pairs]
        # device->host snapshot (the only part that must block the loop)
        host = [_to_host(t) for _, t in pairs]

        def write():
            tmp = self._step_dir(step) + ".tmp"
            final = self._step_dir(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)       # stale .tmp from a crashed writer
            os.makedirs(tmp, exist_ok=True)
            meta = {
                "step": step,
                "paths": paths,
                "shapes": [list(h.shape) for h in host],
                "dtypes": dtypes,
            }
            for i, h in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), h, allow_pickle=False)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if collective:
            import torch.distributed as dist
            self._barrier = dist.is_initialized()
            if self._barrier and dist.get_rank() != 0:
                return
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def save_async(self, step: int, state: Any) -> None:
        self.save(step, state, blocking=False)

    def wait(self) -> None:
        """Until the last save is on disk.  After a collective save (a
        state of DTensors) this is collective too: every rank waits for
        the writer at a barrier."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def restore(self, step: Optional[int] = None, *, target: Any = None,
                specs: Any = None, mesh: Any = None) -> Any:
        """Load a committed checkpoint.

        ``target``: a tree whose structure the leaves are put back into,
        each leaf on the device of ``target``'s leaf at the same path (a
        DTensor leaf with its placements).  With ``specs`` (a spec tree
        like ``target``) and ``mesh``, every leaf is placed on ``mesh``
        by its spec instead.  Without ``target``: {"step", "leaves" (CPU
        tensors), "paths"}."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoints in {self.directory}")
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, "COMMITTED")):
            raise FileNotFoundError(f"checkpoint step {step} not committed")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        host = [_from_host(np.load(os.path.join(d, f"leaf_{i:05d}.npy")), dt)
                for i, dt in enumerate(meta["dtypes"])]
        if target is None:
            return {"step": meta["step"], "leaves": host, "paths": meta["paths"]}
        want = list(iter_leaves(target))
        if [p for p, _ in want] != meta["paths"]:
            raise ValueError(
                f"target has {len(want)} leaves, checkpoint {len(host)}, or "
                "their paths differ")
        by_path = {}
        for (path, proto), h in zip(want, host):
            if h.dtype != proto.dtype or tuple(h.shape) != tuple(proto.shape):
                raise ValueError(
                    f"{path}: checkpoint {h.dtype}{tuple(h.shape)} != target "
                    f"{proto.dtype}{tuple(proto.shape)}")
            by_path[path] = h
        if specs is None:
            return _rebuild(target, {path: _place_like(by_path[path], proto)
                                     for path, proto in want})
        if mesh is None:
            raise ValueError("restore: specs need the mesh to place them on")
        from repro_torch.distributed.sharding import distribute_tree
        dev = ("cpu" if mesh.device_type == "cpu" else
               torch.device("cuda", torch.cuda.current_device()))
        full = _rebuild(target, {k: v.to(dev) for k, v in by_path.items()})
        return distribute_tree(full, specs, mesh)


def _place_like(h: torch.Tensor, proto) -> torch.Tensor:
    """The host tensor on ``proto``'s device; for a DTensor ``proto``,
    this rank's shard of it under ``proto``'s placements."""
    if hasattr(proto, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(h.to(proto.device), proto.device_mesh,
                                 proto.placements, src_data_rank=None)
    return h.to(proto.device)
