"""Points of the diver cell's device idle share in which the host was inside a distgcn.lgs span (B1's shared-mode launch of the Q x D guided completions and the read-back of selections and probabilities), from the traced window's idle gaps (bench_h100/spans.py)."""

from bench_h100 import spans


def read(run):
    return spans.idle_pct(run, "lgs")
