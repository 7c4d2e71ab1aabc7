"""Host ms per chunk spent in ``ServingEngine.step`` outside ``_admit``
and ``_run_chunk`` (engine, serving/engine.py)."""
from portbench import readers


def read(rec):
    return readers.host(rec, "chunk_host_ms")
