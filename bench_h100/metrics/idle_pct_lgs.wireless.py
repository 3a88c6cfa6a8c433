"""Points of the wireless cells' device idle share in which the host was inside a distgcn.lgs span (a B1 launch: the schedule's, the baseline's, or a channel's in the sequential loop), from the traced window's idle gaps (bench_h100/spans.py)."""

from bench_h100 import spans


def read(run):
    return spans.idle_pct(run, "lgs")
