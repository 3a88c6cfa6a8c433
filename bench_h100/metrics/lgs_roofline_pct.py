"""B1 (csrc/lgs.cu, lgs_kernel): its byte bound at 3.35 TB/s over its traced time a launch."""

from bench_h100 import readers


def read(run):
    return readers.roofline_pct(run, "lgs")
