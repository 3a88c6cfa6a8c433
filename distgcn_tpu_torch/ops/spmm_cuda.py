"""Hand-written CUDA BSR SpMM for Hopper (`csrc/bsr_spmm.cu`).

Counterpart of the JAX package's `_spmm_row_kernel` and `_spmm_kernel`
(`distgcn_tpu/ops/spmm.py`): y = S @ x with f32 accumulation over f32 or
bf16 value blocks, int8 structure blocks or bitmap structure blocks.
Bitmap blocks: one warp per 32-row group and feature slice, x read once
per nonzero bitmap word; value and int8 blocks: one warp per output row.
Deterministic (no atomics). `ops.spmm.bsr_spmm_rows` and
`ops.spmm.bsr_spmm` launch it for CUDA tensors; `ops.spmm.bsr_spmm_plain`
is its plain version.

`bsr_spmm_kernel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from distgcn_tpu_torch.ops import _build

_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def bsr_spmm_kernel(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                    blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
                    block_size: int, bitmap: bool = False) -> torch.Tensor:
    """y = S @ x on the card. blk_vals: f32/bf16/int8 [nb, bs, bs] or
    bitmap int32 [nb, bs//32, bs]; row_ptr [R+1] and blk_cols [nb] int32
    (`ops.spmm.bsr_row_ptr`, blocks sorted by row); x: [n_cols, F] f32.
    Returns [n_rows, F] f32. Launches on the current stream without
    synchronising."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be 2-D f32, got {tuple(x.shape)} {x.dtype}")
    check_bsr(blk_vals, row_ptr, blk_cols, n_rows, block_size, bitmap,
              _KINDS, x.shape[0], "bsr_spmm_kernel")
    if x.device != blk_vals.device or not x.is_contiguous():
        raise ValueError("x must be contiguous, on the blocks' device")
    kind = 3 if bitmap else _KINDS[blk_vals.dtype]
    f = x.shape[1]
    y = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    launch = _build.bind("bsr_spmm", "bsr_spmm_launch",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    with torch.cuda.device(x.device):
        launch(blk_vals.data_ptr(), kind, row_ptr.data_ptr(),
               blk_cols.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows,
               block_size, f, _build.stream_of(x))
    bsr_spmm_kernel.launches += 1
    return y


bsr_spmm_kernel.launches = 0
