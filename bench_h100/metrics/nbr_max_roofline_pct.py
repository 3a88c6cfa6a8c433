"""B2 (csrc/bsr_nbr_max.cu, nbr_max_bitmap_kernel): its byte bound over its traced time a launch."""

from bench_h100 import readers


def read(run):
    return readers.roofline_pct(run, "nbr_max")
