"""LGS rounds a slot of the large path: the program's bsr_nbr_max_kernel.launches counter over the traced slots, two launches a round."""

from bench_h100 import readers


def read(run):
    return readers.counter_per_slot(run, "nbr_max_launches", per=2.0)
