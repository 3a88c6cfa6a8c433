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

A round of the large LGS (`large.bsr_lgs`) over bitmap blocks is the f32
kernel twice, each launch ending in the round's element-wise logic for
its own rows instead of storing the maximum: `lgs_round_kernels` checks
the round's arrays once and gives the two launches
(`ops.spmm.lgs_round_passes` calls it; the plain passes are there). Both
take the slots of the previous and of this round's count of nodes left,
and do nothing but zero this round's where the previous one is 0. Each
launch adds one to ``bsr_nbr_max_kernel.launches``, gated or not.
"""

from __future__ import annotations

import ctypes

import torch

from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.ops.spmm_cuda import check_bsr

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


_LGS_ARGTYPES = {
    "rank": [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p],
    "spread": [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]}


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


def lgs_round_kernels(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                      blk_cols: torch.Tensor, key: torch.Tensor,
                      win: torch.Tensor, sel: torch.Tensor,
                      left: torch.Tensor, n_rows: int, block_size: int):
    """A large LGS round's two launches of the f32 kernel over bitmap
    blocks, checked once and bound to these arrays and to the stream
    current now: returns (rank_pass, spread_pass), callables of (prev,
    cur), two different slots of ``left``, that each launch one pass
    without synchronising and add one to ``bsr_nbr_max_kernel.launches``.

    key, win: f32 [n_rows]; sel: int8 [n_rows]; left: int32 [>= 2], the
    rounds' counts of nodes left. rank_pass: left[cur] = 0, then, unless
    left[prev] is 0, with m the neighbour-max of key (a rank while
    undecided, -1 once decided), win[i] = 1.0 where key[i] >= 0 and
    key[i] > m[i], else 0.0. spread_pass, unless left[prev] is 0: a row
    with win set gets sel = 1, an undecided row with a neighbour whose win
    is set gets sel = 0, both get key = -1, and left[cur] gains the rows
    still undecided."""
    caller = "lgs_round_kernels"
    check_bsr(blk_vals, row_ptr, blk_cols, n_rows, block_size, True, (),
              n_rows, caller)
    for t, dtype in ((key, torch.float32), (win, torch.float32),
                     (sel, torch.int8)):
        if (t.shape != (n_rows,) or t.dtype != dtype
                or t.device != blk_vals.device or not t.is_contiguous()):
            raise ValueError(f"{caller}: key, win and sel must be "
                             f"contiguous [{n_rows}] on the blocks' device, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if (left.dim() != 1 or left.numel() < 2 or left.dtype != torch.int32
            or left.device != blk_vals.device or not left.is_contiguous()):
        raise ValueError(f"{caller}: left must be a contiguous int32 "
                         "vector of two or more slots on the blocks' device")
    device = key.device
    operands = (blk_vals, row_ptr, blk_cols, key, win, sel, left)
    blocks = tuple(t.data_ptr() for t in operands[:3])
    grid = (n_rows // block_size, block_size, _build.stream_of(key))
    base, slots = left.data_ptr(), left.numel()

    def bound(kind, arrays):
        fn = _build.bind("bsr_nbr_max", f"bsr_nbr_max_lgs_{kind}_launch",
                         _LGS_ARGTYPES[kind])
        args = (*blocks, *(t.data_ptr() for t in arrays))

        def launch(prev: int, cur: int):
            if not (0 <= prev < slots and 0 <= cur < slots and prev != cur):
                raise ValueError(f"{caller}: slots {prev}, {cur} of "
                                 f"{slots} must differ")
            counts = (base + 4 * prev, base + 4 * cur)
            if torch.cuda.current_device() == device.index:
                fn(*args, *counts, *grid)      # no device switch to pay for
            else:
                with torch.cuda.device(device):
                    fn(*args, *counts, *grid)
            bsr_nbr_max_kernel.launches += 1
        launch.operands = operands      # the memory its pointers address
        return launch

    return (bound("rank", (key, win)), bound("spread", (win, key, sel)))


bsr_nbr_max_kernel.launches = 0
bsr_nbr_max_i32_kernel.launches = 0
