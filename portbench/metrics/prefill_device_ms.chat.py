"""Device ms per admission-prefill graph replay, CUDA events around
each replay (graphs, serving/graphs.py)."""
from portbench import readers


def read(rec):
    return readers.host(rec, "prefill_device_ms")
