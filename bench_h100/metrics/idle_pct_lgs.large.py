"""Points of the large cell's device idle share in which the host was inside a distgcn.lgs span (bsr_lgs: ranks, rounds, host syncs, utility), from the traced window's idle gaps (bench_h100/spans.py)."""

from bench_h100 import spans


def read(run):
    return spans.idle_pct(run, "lgs")
