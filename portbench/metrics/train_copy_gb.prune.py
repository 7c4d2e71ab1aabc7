"""GB the graphed train step copies in and out per call
(``train.copy_bytes`` over ``train.step`` spans; train/graphs.py)."""
from portbench import programspans


def read(rec):
    return programspans.train_copy_gb(rec)
