"""B4b (csrc/bsr_spmm.cu in value mode, bsr_spmm_kernel): its byte bound over its traced time, over the 20 layers of a slot."""

from bench_h100 import readers


def read(run):
    return readers.roofline_pct(run, "edge_spmm")
