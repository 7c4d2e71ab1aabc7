"""Mean seconds of the window's ``pruner.eval`` spans: Algorithm 2's
evaluations, the baseline's too (pruner, core/pruner.py)."""
from portbench import programspans


def read(rec):
    return programspans.mean_s(rec, "pruner.eval")
