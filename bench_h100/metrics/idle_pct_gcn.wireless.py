"""Points of the wireless cells' device idle share in which the host was inside a distgcn.gcn span (features and forward; in the sequential loop each channel's subgraph supports too), from the traced window's idle gaps (bench_h100/spans.py)."""

from bench_h100 import spans


def read(run):
    return spans.idle_pct(run, "gcn")
