"""Share of the traced window in which no operation ran on the card, in the diver's lockstep search (1 - union of device intervals / host-clock window)."""

from bench_h100 import readers


def read(run):
    return readers.idle_pct(run)
