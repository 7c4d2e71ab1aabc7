"""Device ms of device-to-device copies per traced fine-tune step: the
graphed step's copies in and out (train/graphs.py GraphedTrainStep)."""
from portbench import readers


def read(rec):
    return readers.train_copy_ms(rec)
