"""Roofline share of the paged-decode kernel (csrc/paged_decode.cu)
over the traced span."""
from portbench import readers


def read(rec):
    return readers.paged_decode_roofline(rec)
