"""B3 (csrc/cheb_fused.cu, fused_layer_kernel): the larger of its operation and byte bounds over its traced time, over the 20 layers of a slot."""

from bench_h100 import readers


def read(run):
    return readers.roofline_pct(run, "cheb_fused")
