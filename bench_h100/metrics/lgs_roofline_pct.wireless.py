"""B1 (csrc/lgs.cu, lgs_kernel) in the wireless device loop: its byte bound at 3.35 TB/s at the cell's B and N over its traced time a launch."""

from bench_h100 import readers


def read(run):
    return readers.roofline_pct(run, "lgs")
