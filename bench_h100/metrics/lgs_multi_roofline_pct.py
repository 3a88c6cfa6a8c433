"""B1 in its shared-adjacency mode (csrc/lgs.cu with share=D, lgs_kernel): the byte bound of its launches at 3.35 TB/s (bench_h100/counts/lgs_multi.py, each launch by its Q) over their traced time."""

from bench_h100 import readers


def read(run):
    return readers.roofline_pct(run, "lgs_multi")
