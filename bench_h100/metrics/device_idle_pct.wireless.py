"""Share of the untraced window in which no operation ran on the card, in the wireless device loop (1 - device-busy seconds a unit of the trace over the untraced seconds a unit)."""

from bench_h100 import readers


def read(run):
    return readers.idle_pct(run)
