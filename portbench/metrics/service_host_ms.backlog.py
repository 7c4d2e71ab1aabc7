"""Host ms per engine step in ``engine.service``: the fault hook, the
due-time scan, the prefix index's self-check, cancels and deadlines
(engine, serving/engine.py)."""
from portbench import programspans


def read(rec):
    return programspans.per_step_ms(rec, "engine.service", "engine.step")
