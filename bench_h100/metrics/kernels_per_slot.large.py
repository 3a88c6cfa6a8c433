"""Device kernels the large slot loop launches a slot (traced kernels / traced slots)."""

from bench_h100 import readers


def read(run):
    return readers.kernels_per_slot(run)
