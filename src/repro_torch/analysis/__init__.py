"""Torch-aware static analysis + runtime enforcement of the port — the
counterpart of ``src/repro/analysis``.

Static side: `python -m repro_torch.analysis` lints the port for host
syncs in hot paths, PRNG key reuse, CUDA-graph recapture hazards and
ctypes kernel launches that drift from their C signatures (see
`repro_torch.analysis.rules`).  Runtime side:
`repro_torch.analysis.runtime` counts graph captures, kernel library
loads and host-transfer boundaries so tests — and
`ServingEngine.analysis_stats()` — can prove steady-state decode
captures nothing new and makes one declared transfer per chunk.
"""
from .lint import (  # noqa: F401
    Finding,
    HOT_ROOTS,
    ProjectIndex,
    ProjectReport,
    Rule,
    build_index,
    run_project,
    run_rules,
)
