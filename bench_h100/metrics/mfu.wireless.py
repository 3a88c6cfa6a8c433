"""Model FLOPs of the wireless cells' GCN forwards in the untraced window over its time, as a share of the H100's 67 TFLOP/s float32 peak. The sequential loop's forwards are counted at each channel graph's real links and conflicts, an upper bound of the subgraph each one scores (drivers/wireless_episodes.unit_flops)."""

from bench_h100 import readers


def read(run):
    return readers.mfu_pct(run)
