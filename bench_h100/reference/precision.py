"""Rounding to a narrower float format, inside float32 tensors.

The stated precision of a configuration, and the control one step below
it, are applied by rounding values to the significand width of the
format (round to nearest, ties to even): bfloat16 keeps 7 bits, TF32 10,
fp8 e4m3 3. The exponent range is float32's in every case, as a scaled
low-precision path keeps it."""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

SIGNIFICAND_BITS = {"bfloat16": 7, "tf32": 10, "fp8_e4m3": 3}


def round_significand(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 `x` with its significand rounded to `bits` bits (RNE)."""
    drop = 23 - bits
    b = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (b >> drop) & 1
    b = (b + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return b.view(torch.float32)


def rounder(fmt: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> x rounded to `fmt` ('float32' leaves it as it is)."""
    if fmt == "float32":
        return lambda x: x
    bits = SIGNIFICAND_BITS[fmt]
    return lambda x: round_significand(x, bits)


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products in full float32 (TF32 off for cuBLAS and
    cuDNN) inside the block, whatever the process had set; the flags are
    put back afterwards. The reference runs in the program's process, so
    it must not follow a precision the program chose for itself."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def in_full_f32(fn: Callable) -> Callable:
    """`fn` run inside `full_f32`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)
    return wrapped
