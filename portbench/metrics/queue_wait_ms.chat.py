"""Mean ms from ``submit`` to admission of the window's requests: the
program's ``request.queue`` spans (engine, serving/engine.py)."""
from portbench import programspans


def read(rec):
    return programspans.queue_wait_ms(rec)
