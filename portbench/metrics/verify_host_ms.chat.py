"""Host ms per engine step in ``prefix.verify``, the prefix index's
self-check over every entry (engine, serving/pages.py).  A window that
ran no check (0 ms) reads nothing."""
from portbench import programspans


def read(rec):
    return programspans.per_step_ms(rec, "prefix.verify", "engine.step") or None
