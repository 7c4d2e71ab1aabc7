"""Roofline share of the planes kernel (csrc/bsr_planes_matmul.cu)
over the traced span."""
from portbench import readers


def read(rec):
    return readers.planes_roofline(rec)
