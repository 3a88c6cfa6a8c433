"""Hand-written CUDA block-sparse neighbour-max for Hopper
(`csrc/bsr_nbr_max.cu`).

y[i] = max over j with S[i, j] != 0 of x[j] over int8 or bitmap 0/1
blocks, the sentinel on rows with no neighbour. Bitmap blocks: one warp
per 32-row group that visits only the nonzero words; int8 blocks: one CTA
per block-row, one thread per row. Each row takes its neighbours in
row_ptr then column order, the first of equal maxima winning: bit-equal
to `ops.spmm.bsr_nbr_max_plain`, +0.0 / -0.0 ties included. Two payloads,
one template:

- `bsr_nbr_max_kernel`, x f32, sentinel `ops.spmm.NEG_HUGE`: the JAX
  package's `_nbr_max_chunk_kernel`, `_nbr_max_panel_kernel`,
  `_nbr_max_kernel` and `_nbr_max_row_kernel` (`distgcn_tpu/ops/spmm.py`);
- `bsr_nbr_max_i32_kernel`, x int32, sentinel `ops.spmm.I32_SENT`: its
  `_nbr_max_row_kernel_i32`, the sharded solve's rank transport
  (`parallel/large_sharded.py`), exact for every int32 payload.

`ops.spmm.nbr_max_rows` and `ops.spmm.bsr_neighbor_max` launch them for
CUDA tensors. Each wrapper's ``launches`` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.ops.spmm_cuda import check_bsr

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _launch(entry: str, dtype: torch.dtype, caller: str,
            blk_vals: torch.Tensor, row_ptr: torch.Tensor,
            blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
            block_size: int, bitmap: bool) -> torch.Tensor:
    if x.dim() != 1 or x.dtype != dtype:
        name = {torch.float32: "f32", torch.int32: "int32"}[dtype]
        raise ValueError(f"{caller}: x must be 1-D {name}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    check_bsr(blk_vals, row_ptr, blk_cols, n_rows, block_size, bitmap,
              (torch.int8,), x.shape[0], caller)
    if x.device != blk_vals.device or not x.is_contiguous():
        raise ValueError(f"{caller}: x must be contiguous, on the blocks' "
                         "device")
    y = torch.empty((n_rows,), dtype=dtype, device=x.device)
    launch = _build.bind("bsr_nbr_max", entry, _ARGTYPES)
    with torch.cuda.device(x.device):
        launch(blk_vals.data_ptr(), int(bitmap), row_ptr.data_ptr(),
               blk_cols.data_ptr(), x.data_ptr(), y.data_ptr(),
               n_rows // block_size, block_size, _build.stream_of(x))
    return y


def bsr_nbr_max_kernel(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                       blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
                       block_size: int, bitmap: bool = False) -> torch.Tensor:
    """f32 neighbour-max on the card. blk_vals: int8 [nb, bs, bs] or bitmap
    int32 [nb, bs//32, bs]; row_ptr [R+1] and blk_cols [nb] int32; x:
    [n_cols] f32. Returns [n_rows] f32. Launches on the current stream
    without synchronising."""
    y = _launch("bsr_nbr_max_f32_launch", torch.float32,
                "bsr_nbr_max_kernel", blk_vals, row_ptr, blk_cols, x, n_rows,
                block_size, bitmap)
    bsr_nbr_max_kernel.launches += 1
    return y


def bsr_nbr_max_i32_kernel(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                           blk_cols: torch.Tensor, x: torch.Tensor,
                           n_rows: int, block_size: int,
                           bitmap: bool = False) -> torch.Tensor:
    """int32 neighbour-max on the card: as `bsr_nbr_max_kernel` with x and
    the result int32 [n_rows] and `ops.spmm.I32_SENT` on rows with no
    neighbour."""
    y = _launch("bsr_nbr_max_i32_launch", torch.int32,
                "bsr_nbr_max_i32_kernel", blk_vals, row_ptr, blk_cols, x,
                n_rows, block_size, bitmap)
    bsr_nbr_max_i32_kernel.launches += 1
    return y


bsr_nbr_max_kernel.launches = 0
bsr_nbr_max_i32_kernel.launches = 0
