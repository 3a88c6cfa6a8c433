"""Hand-written CUDA block-sparse neighbour-max for Hopper
(`csrc/bsr_nbr_max.cu`).

Counterpart of the JAX package's f32 neighbour-max kernels
(`distgcn_tpu/ops/spmm.py`: `_nbr_max_chunk_kernel`,
`_nbr_max_panel_kernel`, `_nbr_max_kernel`, `_nbr_max_row_kernel`):
y[i] = max over j with S[i, j] != 0 of x[j] over int8 or bitmap 0/1
blocks, `ops.spmm.NEG_HUGE` on rows with no neighbour. One CTA per
block-row, one thread per row: bit-equal to `ops.spmm.bsr_nbr_max_plain`.
`ops.spmm.bsr_neighbor_max` launches it for CUDA tensors.

`bsr_nbr_max_kernel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.ops.spmm_cuda import check_bsr


def bsr_nbr_max_kernel(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                       blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
                       block_size: int, bitmap: bool = False) -> torch.Tensor:
    """Neighbour-max on the card. blk_vals: int8 [nb, bs, bs] or bitmap
    int32 [nb, bs//32, bs]; row_ptr [R+1] and blk_cols [nb] int32; x:
    [n_cols] f32. Returns [n_rows] f32. Launches on the current stream
    without synchronising."""
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"x must be 1-D f32, got {tuple(x.shape)} {x.dtype}")
    check_bsr(blk_vals, row_ptr, blk_cols, n_rows, block_size, bitmap,
              (torch.int8,), x.shape[0], "bsr_nbr_max_kernel")
    if x.device != blk_vals.device or not x.is_contiguous():
        raise ValueError("x must be contiguous, on the blocks' device")
    y = torch.empty((n_rows,), dtype=torch.float32, device=x.device)
    launch = _build.bind("bsr_nbr_max", "bsr_nbr_max_f32_launch",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        launch(blk_vals.data_ptr(), int(bitmap), row_ptr.data_ptr(),
               blk_cols.data_ptr(), x.data_ptr(), y.data_ptr(),
               n_rows // block_size, block_size, _build.stream_of(x))
    bsr_nbr_max_kernel.launches += 1
    return y


bsr_nbr_max_kernel.launches = 0
