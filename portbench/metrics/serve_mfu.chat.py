"""% of the bf16 peak that the window's model FLOPs fill (the whole
model step: models/transformer.py)."""
from portbench import readers


def read(rec):
    return readers.serve_mfu(rec)
