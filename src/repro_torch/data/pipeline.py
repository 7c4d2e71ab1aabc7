"""Host data pipeline, torch port of ``src/repro/data/pipeline.py``:
step-indexed deterministic batches placed on one device or on a mesh,
and a background prefetch.

* Batches are a pure function of (seed, global step), so a restart
  replays exactly the same sequence with no pipeline state.
* On a CUDA device each batch is staged in pinned host memory and copied
  with ``non_blocking=True``, so the copy overlaps the card's work.
* With ``mesh`` (a ``DeviceMesh``) each batch leaf becomes a DTensor
  sharded on its first dim over the ``batch_axes`` the mesh has and
  replicated over the others, as the reference places it (:52-60).
  Every rank synthesises the same host batch and keeps its own rows.
* ``run`` prefetches ``prefetch`` steps ahead on a worker thread
  (overlapping the host's synthesis with the device's compute).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.device import resolve_device
from .synthetic import TokenTask

__all__ = ["LMPipeline"]


class LMPipeline:
    def __init__(self, task: TokenTask, batch: int, seq: int, *, device=None,
                 mesh=None, batch_axes=("data",), prefetch: int = 2):
        self.task = task
        self.batch = batch
        self.seq = seq
        self.mesh = mesh
        self.batch_axes = batch_axes
        if mesh is not None and device is None:
            device = ("cpu" if mesh.device_type == "cpu" else
                      torch.device("cuda", torch.cuda.current_device()))
        self.device = resolve_device(device)
        self._prefetch = prefetch
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic access ------------------------------------------------

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        host = self.task.batch(step, self.batch, self.seq)
        if self.device.type != "cuda":
            out = {k: v.to(self.device) for k, v in host.items()}
        else:
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
        if self.mesh is None:
            return out
        from repro_torch.distributed.sharding import distribute_tree

        names = tuple(self.mesh.mesh_dim_names)
        axes = tuple(a for a in self.batch_axes if a in names)
        spec = (axes if axes else None,)
        return distribute_tree(out, {k: spec for k in out}, self.mesh)

    # -- prefetching iterator --------------------------------------------------

    def run(self, start_step: int, num_steps: int) -> Iterator[Dict[str, Any]]:
        if self._prefetch <= 0:
            for s in range(start_step, start_step + num_steps):
                yield self.batch_at(s)
            return

        def worker():
            for s in range(start_step, start_step + num_steps):
                if self._stop.is_set():
                    return
                self._queue.put(self.batch_at(s))

        self._stop.clear()
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        for _ in range(num_steps):
            yield self._queue.get()
        self._thread.join(timeout=5)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            while not self._queue.empty():
                self._queue.get_nowait()
