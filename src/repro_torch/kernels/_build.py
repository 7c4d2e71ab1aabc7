"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``.cu`` source becomes its own shared library with a plain C entry
point, compiled for Hopper with ``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC`` into ``build/kernels/`` at the
repository root on first use, and loaded with ``ctypes``.  A library's
file name carries a hash of every source and header plus the flags, so an
edited source rebuilds and a stale one is never loaded.  ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc`` and no card.

``launch_counts`` holds one plain integer per kernel; each wrapper adds
one where it launches its kernel, and nowhere else.  A CUDA graph
launches its kernels without calling the wrappers: ``recorded_launches``
takes back what the wrappers counted while the graph was captured (a
capture launches nothing) and keeps it, and ``add_launches`` adds it at
every replay (``serving/graphs.py``).  Each library load counts in
``analysis.runtime.compile_events``, as a graph capture does.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterator

from repro_torch.analysis import runtime as analysis_runtime

__all__ = [
    "SOURCES", "NVCC_FLAGS", "build_all", "build_logs", "library", "check",
    "launch_counts", "reset_launch_counts", "add_launches",
    "recorded_launches",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "bsr_matmul": "bsr_matmul.cu",
    "paged_attention_decode": "paged_decode.cu",
    "paged_attention_prefill": "paged_prefill.cu",
    "bsr_planes_matmul": "bsr_planes_matmul.cu",
    "structure_norms": "structure_norms.cu",
}
HEADERS = ("common.cuh", "bsr_split.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts: Dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: Dict[str, ctypes.CDLL] = {}
# build/kernels at the repository root (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Add per-kernel launch counts (a graph replay's)."""
    for name, n in counts.items():
        launch_counts[name] += n


@contextlib.contextmanager
def recorded_launches() -> Iterator[Dict[str, int]]:
    """Inside the block, the wrappers' counts are recorded, not counted:
    on exit ``launch_counts`` is back where it was and the yielded dict
    holds each kernel's count from the block (for a graph capture)."""
    before = dict(launch_counts)
    rec: Dict[str, int] = {}
    try:
        yield rec
    finally:
        for name, n in before.items():
            if launch_counts[name] != n:
                rec[name] = launch_counts[name] - n
            launch_counts[name] = n


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set NVCC or CUDA_HOME)")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *HEADERS):
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    source = SOURCES[name]
    return BUILD_DIR / f"{Path(source).stem}_{_digest(source)}.so"


def build_all() -> float:
    """Compile every missing library, one ``nvcc`` per source started
    together.  Returns the wall seconds spent; raises on any failure
    with the compiler's output."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in SOURCES.items():
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_logs() -> Dict[str, str]:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of each library's last build."""
    logs = {}
    for name in SOURCES:
        log = _lib_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        analysis_runtime.count_compile()
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library(name).repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")
