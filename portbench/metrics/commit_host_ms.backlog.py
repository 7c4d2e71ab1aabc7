"""Host ms per decode chunk in ``engine.commit``: the chunk's outputs
unpacked, emitted tokens, finished rows retired (engine,
serving/engine.py)."""
from portbench import programspans


def read(rec):
    return programspans.per_step_ms(rec, "engine.commit", "engine.chunk")
