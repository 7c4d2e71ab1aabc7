"""Prefix-index entries the engine's per-step self-check walks, per
step (``prefix.entries_verified``; engine, serving/pages.py)."""
from portbench import programspans


def read(rec):
    return programspans.counter_per(rec, "prefix.entries_verified", "engine.step")
