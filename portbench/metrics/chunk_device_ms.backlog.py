"""Device ms per decode-chunk graph replay, CUDA events around each
replay (graphs, serving/graphs.py)."""
from portbench import readers


def read(rec):
    return readers.host(rec, "chunk_device_ms")
