"""Production mesh construction — torch port of
``src/repro/launch/mesh.py``.

Functions, not module-level constants, so importing this module touches
no device or process group.  Single-pod: 16 x 16 = 256 devices on
("data", "model"); multi-pod: 2 x 16 x 16 = 512 on ("pod", "data",
"model"), the pod axis pure data parallelism with the optional int8
compressed gradient all-reduce (``optim/compression.py``).  The world is
the process group's (one rank per device), or 1 without one.
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_mesh_shape", "make_test_mesh"]


def make_mesh_shape(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def _world_size() -> int:
    """Ranks of the initialized process group, 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over the process group; raises ``RuntimeError``
    naming the needed and the visible device count on a smaller world."""
    from repro_torch.distributed import make_mesh

    shape, axes = make_mesh_shape(multi_pod=multi_pod)
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices but only {have} are visible — "
            f"start one rank per device (torch.distributed, world size {n}) "
            f"before building the production mesh.")
    return make_mesh(shape, axes, device_type=device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str = "cuda"):
    """The reference's ``make_test_mesh`` (same name and defaults, so code
    and tests read alike in both packages): ``make_mesh`` over a process
    group whose world size is the mesh's (the CPU tests pass
    ``device_type="cpu"`` over gloo ranks)."""
    from repro_torch.distributed import make_mesh
    return make_mesh(shape, axes, device_type=device_type)
