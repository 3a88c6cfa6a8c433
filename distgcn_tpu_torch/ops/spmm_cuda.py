"""Hand-written CUDA BSR SpMM for Hopper (`csrc/bsr_spmm.cu`).

Counterpart of the JAX package's `_spmm_row_kernel` and `_spmm_kernel`
(`distgcn_tpu/ops/spmm.py`): y = S @ x with f32 accumulation. One kernel,
the bitmap walk: one warp per 32-row group and feature slice, x read once
per nonzero bitmap word, and for a weighted matrix (the edge form,
`ops.spmm.EdgeValues`) one f32 or bf16 value per set bit, multiplied in.
Deterministic (no atomics). `ops.spmm.bsr_spmm_rows`, `ops.spmm.bsr_spmm`
and `ops.spmm.edge_spmm_rows` launch it for CUDA tensors;
`ops.spmm.edge_spmm_plain` and `ops.spmm.bsr_spmm_plain` are its plain
versions.

`bsr_spmm_kernel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from distgcn_tpu_torch.ops import _build

_BLOCK_KINDS = (torch.float32, torch.bfloat16, torch.int8)
_VALUE_KINDS = {torch.float32: 1, torch.bfloat16: 2}


def check_bsr(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
              blk_cols: torch.Tensor, n_rows: int, block_size: int,
              bitmap: bool, dtypes, n_cols: int, caller: str) -> None:
    """Raise ValueError unless the BSR operands fit the CUDA kernels: one
    CUDA device, contiguous, int32 block ids, `block_size` a multiple of
    32 dividing `n_rows` and `n_cols`, blocks of a dtype in `dtypes` (int32
    words when `bitmap`)."""
    bs = block_size
    if not (32 <= bs <= 1024 and bs % 32 == 0):
        raise ValueError(f"{caller}: block_size {bs} must be a multiple of "
                         "32 in 32..1024")
    if n_rows % bs or n_cols % bs:
        raise ValueError(f"{caller}: n_rows {n_rows} and n_cols {n_cols} "
                         f"must be multiples of block_size {bs}")
    nb = blk_vals.shape[0] if blk_vals.dim() == 3 else -1
    want = (nb, bs // 32, bs) if bitmap else (nb, bs, bs)
    if tuple(blk_vals.shape) != want:
        raise ValueError(f"{caller}: blocks of shape {tuple(blk_vals.shape)}"
                         f", expected {want}")
    if bitmap and blk_vals.dtype != torch.int32:
        raise ValueError(f"{caller}: bitmap blocks must be int32, got "
                         f"{blk_vals.dtype}")
    if not bitmap and blk_vals.dtype not in dtypes:
        raise ValueError(f"{caller}: blocks must be one of {list(dtypes)}, "
                         f"got {blk_vals.dtype}")
    if row_ptr.shape != (n_rows // bs + 1,) or blk_cols.shape != (nb,):
        raise ValueError(f"{caller}: row_ptr {tuple(row_ptr.shape)} / "
                         f"blk_cols {tuple(blk_cols.shape)} do not match "
                         f"{n_rows // bs} block-rows and {nb} blocks")
    if row_ptr.dtype != torch.int32 or blk_cols.dtype != torch.int32:
        raise ValueError(f"{caller}: row_ptr and blk_cols must be int32")
    for t in (blk_vals, row_ptr, blk_cols):
        if not t.is_cuda or t.device != blk_vals.device:
            raise ValueError(f"{caller} needs every operand on one CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{caller}: operands must be contiguous")


def _check_values(words: torch.Tensor, vals: torch.Tensor,
                  off: Optional[torch.Tensor]) -> None:
    """The edge form's values: 1-D f32 or bf16 and int32 offsets
    [nb * bs/32 + 1], contiguous, on the words' device. That ``vals``
    holds ``off[-1]`` values is the builders' contract: reading off[-1]
    here would synchronise with the card."""
    if vals.dim() != 1 or vals.dtype not in _VALUE_KINDS:
        raise ValueError(f"bsr_spmm_kernel: vals must be 1-D f32 or bf16, "
                         f"got {tuple(vals.shape)} {vals.dtype}")
    want = (words.shape[0] * words.shape[1] + 1,)
    if off is None or off.dtype != torch.int32 or tuple(off.shape) != want:
        raise ValueError(f"bsr_spmm_kernel: off must be int32 of shape "
                         f"{want}")
    for t in (vals, off):
        if t.device != words.device or not t.is_contiguous():
            raise ValueError("bsr_spmm_kernel: vals and off must be "
                             "contiguous, on the words' device")


def bsr_spmm_kernel(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                    blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
                    block_size: int, bitmap: bool = False,
                    vals: Optional[torch.Tensor] = None,
                    off: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = S @ x on the card. With ``bitmap``: blk_vals are int32 bitmap
    words [nb, bs//32, bs], and ``vals`` / ``off`` (the edge form,
    `ops.spmm.EdgeValues`) the values of the set bits, or None for a 0/1
    structure. Without: f32/bf16/int8 blocks [nb, bs, bs], whose edge form
    is built for this call (`ops.spmm.edge_values`). row_ptr [R+1] and
    blk_cols [nb] int32 (`ops.spmm.bsr_row_ptr`, blocks sorted by row);
    x: [n_cols, F] f32. Returns [n_rows, F] f32. Launches on the current
    stream without synchronising."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be 2-D f32, got {tuple(x.shape)} {x.dtype}")
    check_bsr(blk_vals, row_ptr, blk_cols, n_rows, block_size, bitmap,
              _BLOCK_KINDS, x.shape[0], "bsr_spmm_kernel")
    if x.device != blk_vals.device or not x.is_contiguous():
        raise ValueError("x must be contiguous, on the blocks' device")
    if not bitmap:
        if vals is not None or off is not None:
            raise ValueError("bsr_spmm_kernel: vals and off go with bitmap "
                             "words")
        from distgcn_tpu_torch.ops.spmm import edge_values
        ev = edge_values(blk_vals, row_ptr)
        blk_vals, vals, off = ev.words, ev.vals, ev.off
    kind = 0
    if vals is not None:
        _check_values(blk_vals, vals, off)
        kind = _VALUE_KINDS[vals.dtype]
    f = x.shape[1]
    y = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    launch = _build.bind("bsr_spmm", "bsr_spmm_launch",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        launch(blk_vals.data_ptr(), row_ptr.data_ptr(), blk_cols.data_ptr(),
               0 if vals is None else vals.data_ptr(), kind,
               0 if vals is None else off.data_ptr(), x.data_ptr(),
               y.data_ptr(), n_rows, block_size, f, _build.stream_of(x))
    bsr_spmm_kernel.launches += 1
    return y


bsr_spmm_kernel.launches = 0
