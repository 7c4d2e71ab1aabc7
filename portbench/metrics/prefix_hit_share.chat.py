"""% of the window's admitted prompt tokens served from the prefix
cache (engine, serving/pages.py ``PrefixIndex``, via ``prefix_stats``)."""
from portbench import readers


def read(rec):
    return readers.prefix_hit_share(rec)
