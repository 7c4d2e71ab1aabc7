"""Run a function on N ranks of a fresh process group.

``run_ranks(fn, world_size, backend=..., device_type=..., init_file=...)``
spawns ``world_size`` processes (``torch.multiprocessing.spawn``, the
"spawn" start method), initializes the default process group in each
from a ``file://`` store at ``init_file``, calls ``fn(rank, *args)``,
destroys the group in a ``finally`` and returns every rank's result, in
rank order.  The rendezvous is a file under the caller's directory, not
a TCP port, so runs in parallel (test workers) never collide; the file
must not exist yet.  ``fn`` must be importable by name (a module-level
function) and its result picklable by ``torch.save``.

With ``device_type="cuda"`` rank r selects card ``r % device_count``:
two ranks on one card share it (over gloo: NCCL refuses two ranks on
one device).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch

__all__ = ["run_ranks"]


def _result_path(init_file: str, rank: int) -> Path:
    return Path(f"{init_file}.rank{rank}.pt")


def _entry(rank: int, fn: Callable, world_size: int, backend: str,
           device_type: str, init_file: str, args: Sequence[Any]) -> None:
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank)
    try:
        result = fn(rank, *args)
        torch.save(result, _result_path(init_file, rank))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *, backend: str,
              device_type: str, init_file, args: Sequence[Any] = ()) -> List[Any]:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each run in its
    own process of one ``world_size``-rank group.  Raises if any rank
    fails (``torch.multiprocessing.ProcessRaisedException`` with the
    rank's traceback)."""
    import torch.multiprocessing as mp

    init_file = os.fspath(init_file)
    if os.path.exists(init_file):
        raise FileExistsError(f"run_ranks: rendezvous file {init_file} exists")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"run_ranks: unsupported device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device is available for "
                           "device_type='cuda'")
    mp.spawn(_entry, args=(fn, world_size, backend, device_type, init_file,
                           tuple(args)),
             nprocs=world_size, join=True, start_method="spawn")
    results = []
    for rank in range(world_size):
        path = _result_path(init_file, rank)
        results.append(torch.load(path, weights_only=False))
        path.unlink()
    return results
