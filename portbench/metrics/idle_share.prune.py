"""% of the traced span in which no operation ran on the device."""
from portbench import readers


def read(rec):
    return readers.idle_share(rec)
