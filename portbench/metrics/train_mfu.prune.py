"""% of the bf16 peak that the window's fine-tune steps fill, by the
dense model's FLOPs (the whole train step)."""
from portbench import readers


def read(rec):
    return readers.train_mfu(rec)
