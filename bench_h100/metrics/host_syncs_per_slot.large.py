"""Host syncs a slot of the large LGS: distgcn.sync spans (one a bsr_lgs round and one at its end) over the traced slots (bench_h100/spans.py)."""

from bench_h100 import spans


def read(run):
    return spans.count_per_slot(run, "distgcn.sync")
