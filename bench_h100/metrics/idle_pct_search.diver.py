"""Points of the diver cell's device idle share in which the host was in the search (distgcn.slot or distgcn.episode) outside its GCN and LGS spans: the heaps, pops, masks and absorb (bench_h100/spans.py)."""

from bench_h100 import spans


def read(run):
    return spans.idle_pct(run, "slot")
