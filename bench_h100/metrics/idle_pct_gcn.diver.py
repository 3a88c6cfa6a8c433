"""Points of the diver cell's device idle share in which the host was inside a distgcn.gcn span (a device call's masking, state arrays, forward, head softmax and guided weights), from the traced window's idle gaps (bench_h100/spans.py)."""

from bench_h100 import spans


def read(run):
    return spans.idle_pct(run, "gcn")
