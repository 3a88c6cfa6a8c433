"""Model FLOPs of the dense GCN forwards in the untraced window over its time, as a share of the H100's 67 TFLOP/s float32 peak."""

from bench_h100 import readers


def read(run):
    return readers.mfu_pct(run)
