"""Seconds per knapsack step of the window (core/pruner.py prune_step:
scoring, the MDKP of core/knapsack.py and the masks), the card
synchronised on both sides."""
from portbench import readers


def read(rec):
    return readers.knapsack_s(rec)
