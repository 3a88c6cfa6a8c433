"""Points of the wireless cells' device idle share in which the host was in the loop (distgcn.slot or distgcn.episode) outside its GCN and LGS spans: draws, utilities, drain estimates, queue update, stats (bench_h100/spans.py)."""

from bench_h100 import spans


def read(run):
    return spans.idle_pct(run, "slot")
