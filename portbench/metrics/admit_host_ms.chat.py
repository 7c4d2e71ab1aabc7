"""Host ms per admission of the window, the replays' device time and
any capture taken out (engine, serving/engine.py ``_admit``)."""
from portbench import readers


def read(rec):
    return readers.host(rec, "admit_host_ms")
