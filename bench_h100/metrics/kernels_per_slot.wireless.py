"""Device kernels the wireless device loop launches a slot (traced kernels / traced slots; a unit is one episode at each load)."""

from bench_h100 import readers


def read(run):
    return readers.kernels_per_slot(run)
