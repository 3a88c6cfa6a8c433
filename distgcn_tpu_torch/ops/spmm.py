"""Block-sparse (BSR) matrices for large graphs: builders, plain versions
and dispatch of the sparse products.

Port of `distgcn_tpu/ops/spmm.py`:

- `BsrMatrix`: dense [bs, bs] blocks at (row, col) block ids, sorted by
  (row, col), with one (zero) block for every block-row that has none.
  The JAX package pads the block count to a multiple of 8 for its
  chunk-grid TPU kernels; the port has no padding blocks, so every block
  is real (``nb_real == num_blocks``).
- Bitmap blocks (``dtype="bits"``): [nb, bs//32, bs] int32 words, bit
  ``i % 32`` of word ``[i // 32, j]`` = cell ``(i, j)`` (the JAX package's
  `pack_bits_blocks` layout), packed straight from COO.
- `bsr_spmm_rows` / `bsr_spmm` (y = S @ x, the counterparts of the JAX
  row-grid and block-grid SpMMs) and `bsr_neighbor_max`
  (y[i] = max over structural neighbours j of x[j]) run their plain
  PyTorch versions on CPU tensors and the hand-written CUDA kernels
  (`ops/spmm_cuda.py`, `ops/nbr_max_cuda.py`) on CUDA tensors.
  `spmm_rows` and `nbr_max_rows` are the same dispatch on raw block
  arrays (the sharded path's panels); the neighbour-max takes an f32 or
  an int32 payload (the JAX `_bsr_nbr_max_rows` and
  `_bsr_nbr_max_rows_i32`).
- `ell_pack` / `ell_spmm`: the ELLPACK gather form (the non-BSR route).
- `SparseSupport`: the BSR route on a CUDA device, the ELL route on the
  CPU, as the JAX package chooses Pallas on a TPU and XLA elsewhere.

The panel and gather-window metadata of the JAX package (`bsr_panels`,
`panel_gather_meta`, the VMEM fit checks) only tile the TPU kernels'
VMEM; the Hopper kernels read none of it, so it is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.utils.device import resolve_device

NEG_HUGE = -3.0e38     # neighbour-max value of a row with no neighbour (f32)
I32_SENT = -(2 ** 31) + 1   # the same for an int32 payload


def pack_bits_blocks(blk: np.ndarray) -> np.ndarray:
    """Host pack: [nb, bs, bs] 0/1 blocks -> [nb, bs//32, bs] int32 bitmap
    blocks (bit i % 32 of word [i // 32, j] = cell (i, j))."""
    nb, bs, _ = blk.shape
    if bs % 32:
        raise ValueError(f"bitmap blocks need bs % 32 == 0, got {bs}")
    b = (np.asarray(blk) != 0).astype(np.uint32).reshape(nb, bs // 32, 32,
                                                         bs)
    shifts = np.arange(32, dtype=np.uint32)[None, None, :, None]
    return np.bitwise_or.reduce(b << shifts, axis=2).view(np.int32)


def unpack_bits(words: torch.Tensor, bs: int) -> torch.Tensor:
    """[nb, bs//32, bs] int32 bitmap words -> [nb, bs, bs] bool cells."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None, :] >> shifts[None, None, :, None]) & 1
    return bits.reshape(words.shape[0], bs, bs).bool()


def block_values(blk_vals: torch.Tensor, bs: int, bitmap: bool
                 ) -> torch.Tensor:
    """Blocks of any kind (f32/bf16 values, int8 or bitmap structure) as
    f32 [nb, bs, bs]."""
    if bitmap:
        return unpack_bits(blk_vals, bs).to(torch.float32)
    return blk_vals.to(torch.float32)


@dataclass
class BsrMatrix:
    """Block-sparse S: blk_vals [nb, bs, bs] (or [nb, bs//32, bs] int32 if
    ``bitmap``), blk_rows/blk_cols [nb] int32 block ids sorted by
    (row, col)."""
    blk_vals: torch.Tensor
    blk_rows: torch.Tensor
    blk_cols: torch.Tensor
    n_rows: int             # padded row count (multiple of bs)
    n_cols: int
    block_size: int
    nb_real: int = 0
    bitmap: bool = False

    @classmethod
    def from_scipy(cls, s: sp.spmatrix, block_size: int = 128,
                   dtype=np.float32, device=None) -> "BsrMatrix":
        """Build from scipy. ``dtype``: a numpy dtype for value or int8
        structure blocks, ``torch.bfloat16`` for bf16 value blocks, or
        ``"bits"`` for bitmap structure blocks packed from COO (the dense
        int8 stream is never built)."""
        dev = resolve_device(device)
        s = sp.csr_matrix(s)
        n, m = s.shape
        bs = block_size
        nr = -(-n // bs) * bs
        nc = -(-m // bs) * bs
        coo = s.tocoo()
        br = coo.row // bs
        bc = coo.col // bs
        nbc = nc // bs
        keys = br.astype(np.int64) * nbc + bc
        # every block-row gets at least one (zero) block, at column 0 as in
        # the JAX package's BsrMatrix.from_scipy
        empty_rows = np.setdiff1d(np.arange(nr // bs, dtype=np.int64),
                                  np.unique(br))
        keys = np.concatenate([keys, empty_rows * nbc])
        uniq, inv = np.unique(keys, return_inverse=True)
        inv = inv[: coo.nnz]
        nb = uniq.size
        rows = (uniq // nbc).astype(np.int32)
        cols = (uniq % nbc).astype(np.int32)
        bitmap = isinstance(dtype, str) and dtype == "bits"
        if bitmap:
            if bs % 32:
                raise ValueError(f"bitmap blocks need bs % 32 == 0, got {bs}")
            words = np.zeros((nb, bs // 32, bs), np.uint32)
            on = coo.data != 0
            ri = coo.row[on] % bs
            np.bitwise_or.at(
                words, (inv[on], ri // 32, coo.col[on] % bs),
                np.uint32(1) << (ri % 32).astype(np.uint32))
            vals = torch.from_numpy(words.view(np.int32))
        elif dtype is torch.bfloat16:
            v = np.zeros((nb, bs, bs), np.float32)
            v[inv, coo.row % bs, coo.col % bs] = coo.data
            vals = torch.from_numpy(v).to(torch.bfloat16)
        else:
            v = np.zeros((nb, bs, bs), dtype=dtype)
            v[inv, coo.row % bs, coo.col % bs] = coo.data
            vals = torch.from_numpy(v)
        return cls(vals.to(dev), torch.from_numpy(rows).to(dev),
                   torch.from_numpy(cols).to(dev), nr, nc, bs, nb_real=nb,
                   bitmap=bitmap)

    @property
    def num_blocks(self) -> int:
        return self.blk_vals.shape[0]


def bsr_row_ptr(s: BsrMatrix) -> torch.Tensor:
    """CSR-style block-row pointer [R+1] int32 from the sorted blk_rows."""
    nr = s.n_rows // s.block_size
    counts = torch.bincount(s.blk_rows.long(), minlength=nr)
    return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)


def _block_rows(row_ptr: torch.Tensor) -> torch.Tensor:
    nr = row_ptr.shape[0] - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(nr, device=row_ptr.device), counts)


# ---------------------------------------------------------------------------
# y = S @ x
# ---------------------------------------------------------------------------

def _addressed(row_ptr: torch.Tensor, *arrays):
    """The blocks that row_ptr addresses: a panel of the sharded path pads
    its block arrays to a common count past ``row_ptr[-1]``."""
    nb = int(row_ptr[-1])
    return tuple(a[:nb] for a in arrays)


def bsr_spmm_plain(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                   blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
                   block_size: int, bitmap: bool = False) -> torch.Tensor:
    """Plain PyTorch y = S @ x: f32 [n_rows, F], 0 on block-rows with no
    block. x: [n_cols, F] f32 (n_cols a multiple of bs)."""
    bs = block_size
    f = x.shape[1]
    blk_vals, blk_cols = _addressed(row_ptr, blk_vals, blk_cols)
    vals = block_values(blk_vals, bs, bitmap)                 # [nb, bs, bs]
    xs = x.reshape(-1, bs, f)[blk_cols.long()]                # [nb, bs, F]
    prod = torch.bmm(vals, xs.to(torch.float32))
    out = torch.zeros((n_rows // bs, bs, f), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, _block_rows(row_ptr), prod)
    return out.reshape(n_rows, f)


def spmm_rows(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
              blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
              block_size: int, bitmap: bool = False) -> torch.Tensor:
    """y = S @ x on raw block arrays (the JAX `_bsr_spmm_rows`): the plain
    version for CPU tensors, the SpMM kernel for CUDA tensors. Blocks past
    ``row_ptr[-1]`` are never read. x: [n_cols, F] f32."""
    if x.device.type == "cpu":
        return bsr_spmm_plain(blk_vals, row_ptr, blk_cols, x, n_rows,
                              block_size, bitmap)
    from distgcn_tpu_torch.ops.spmm_cuda import bsr_spmm_kernel
    return bsr_spmm_kernel(blk_vals, row_ptr, blk_cols, x, n_rows,
                           block_size, bitmap)


def _pad_rows(x: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    pad = x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), value)
    return torch.cat([x, pad])


def bsr_spmm_rows(s: BsrMatrix, x: torch.Tensor,
                  row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = S @ x with f32 accumulation, for value (f32/bf16) and structure
    (int8/bitmap) blocks; block-rows with no block give 0. Pass a
    precomputed `row_ptr` (`bsr_row_ptr`) to save its host-side build.
    Returns [n_rows, F] f32. On CUDA tensors this launches the SpMM kernel
    without synchronising."""
    if row_ptr is None:
        row_ptr = bsr_row_ptr(s)
    x = _pad_rows(x, s.n_cols)
    return spmm_rows(s.blk_vals, row_ptr, s.blk_cols, x, s.n_rows,
                     s.block_size, s.bitmap)


def bsr_spmm(s: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Counterpart of the JAX block-grid `bsr_spmm_pallas`: y = S @ x from
    the block ids alone. The same kernel as `bsr_spmm_rows`; block-rows
    with no block give 0."""
    return bsr_spmm_rows(s, x)


# ---------------------------------------------------------------------------
# y[i] = max over neighbours j of x[j]
# ---------------------------------------------------------------------------

def nbr_max_sentinel(dtype: torch.dtype):
    """The value of a row with no neighbour: `I32_SENT` for an int32
    payload, `NEG_HUGE` for f32."""
    if dtype == torch.int32:
        return I32_SENT
    if dtype == torch.float32:
        return NEG_HUGE
    raise ValueError(f"neighbour-max payloads are f32 or int32, got {dtype}")


def bsr_nbr_max_plain(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                      blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
                      block_size: int, bitmap: bool = False) -> torch.Tensor:
    """Plain PyTorch neighbour-max over int8 or bitmap 0/1 blocks.
    x: [n_cols] f32 or int32. Returns [n_rows] of x's dtype, the
    sentinel (`nbr_max_sentinel`) where a row has no neighbour. Blocks
    past ``row_ptr[-1]`` are never read. Of equal maxima (+0.0 and -0.0)
    a row keeps the first in its blocks' row_ptr order, then in column
    order, as the kernels do."""
    bs = block_size
    sent = nbr_max_sentinel(x.dtype)
    blk_vals, blk_cols = _addressed(row_ptr, blk_vals, blk_cols)
    out = torch.full((n_rows // bs, bs), sent, dtype=x.dtype,
                     device=x.device)
    nb = blk_cols.shape[0]
    if nb == 0:
        return out.reshape(n_rows)
    ind = (unpack_bits(blk_vals, bs) if bitmap
           else blk_vals != 0)                                 # [nb, bs, bs]
    xs = x.reshape(-1, bs)[blk_cols.long()]                    # [nb, bs]
    cand = torch.where(ind, xs[:, None, :],
                       torch.tensor(sent, dtype=x.dtype, device=x.device))
    # argmax gives the first maximal column; the gather keeps its sign
    bm = cand.gather(-1, cand.argmax(dim=-1, keepdim=True))[..., 0]
    rows = _block_rows(row_ptr)[:, None].expand(-1, bs)        # [nb, bs]
    out.scatter_reduce_(0, rows, bm, "amax")
    # the first block whose maximum equals the row's
    order = torch.arange(nb, device=x.device)[:, None].expand(-1, bs)
    first = torch.full_like(out, nb, dtype=torch.int64)
    first.scatter_reduce_(0, rows, torch.where(bm == out.gather(0, rows),
                                               order, nb), "amin")
    lane = torch.arange(bs, device=x.device)[None, :].expand_as(first)
    return torch.where(first < nb, bm[first.clamp(max=nb - 1), lane],
                       out).reshape(n_rows)


def nbr_max_rows(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                 blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
                 block_size: int, bitmap: bool = False) -> torch.Tensor:
    """Neighbour-max on raw block arrays, the JAX `_bsr_nbr_max_rows` (x
    f32) and `_bsr_nbr_max_rows_i32` (x int32): the plain version for CPU
    tensors; for CUDA tensors the f32 or the int32 kernel, which launch
    without synchronising. Blocks past ``row_ptr[-1]`` are never read."""
    if x.device.type == "cpu":
        return bsr_nbr_max_plain(blk_vals, row_ptr, blk_cols, x, n_rows,
                                 block_size, bitmap)
    from distgcn_tpu_torch.ops import nbr_max_cuda
    kernel = (nbr_max_cuda.bsr_nbr_max_i32_kernel if x.dtype == torch.int32
              else nbr_max_cuda.bsr_nbr_max_kernel)
    return kernel(blk_vals, row_ptr, blk_cols, x, n_rows, block_size, bitmap)


def bsr_neighbor_max(s: BsrMatrix, x: torch.Tensor,
                     row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[i] = max over structural neighbours j of x[j], over int8 or bitmap
    structure blocks. x: [<= n_cols] f32 or int32, padded with the
    sentinel. Returns [n_rows] of x's dtype with the sentinel on rows with
    no neighbour (padding rows and empty block-rows included). On CUDA
    tensors this launches a neighbour-max kernel without synchronising."""
    if row_ptr is None:
        row_ptr = bsr_row_ptr(s)
    x = _pad_rows(x, s.n_cols, nbr_max_sentinel(x.dtype))
    return nbr_max_rows(s.blk_vals, row_ptr, s.blk_cols, x, s.n_rows,
                        s.block_size, s.bitmap)


# ---------------------------------------------------------------------------
# ELLPACK gather form
# ---------------------------------------------------------------------------

def ell_pack(s: sp.spmatrix, dtype=np.float32
             ) -> Tuple[np.ndarray, np.ndarray]:
    """cols [N, K], vals [N, K] with K = max row degree (padding: self
    column, zero value)."""
    s = sp.csr_matrix(s)
    n = s.shape[0]
    deg = np.diff(s.indptr)
    k = max(int(deg.max()) if n else 1, 1)
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    vals = np.zeros((n, k), dtype=dtype)
    if s.nnz:
        rows = np.repeat(np.arange(n), deg)
        pos = np.arange(s.nnz) - s.indptr[rows]
        cols[rows, pos] = s.indices
        vals[rows, pos] = s.data
    return cols, vals


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    """y[i] = sum_k vals[i,k] * x[cols[i,k]] — gather-based SpMM."""
    return torch.einsum("nk,nkf->nf", vals, x[cols.long()])


class SparseSupport:
    """Sparse support matrix: BSR SpMM kernel on a CUDA device, ELL gather
    on the CPU."""

    def __init__(self, s: sp.spmatrix, block_size: int = 512, device=None):
        dev = resolve_device(device)
        self.use_bsr = dev.type == "cuda"
        if self.use_bsr:
            self.bsr = BsrMatrix.from_scipy(s, block_size, device=dev)
            self.row_ptr = bsr_row_ptr(self.bsr)
        else:
            cols, vals = ell_pack(s)
            self.cols = torch.from_numpy(cols)
            self.vals = torch.from_numpy(vals)
        self.n = s.shape[0]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_bsr:
            return bsr_spmm_rows(self.bsr, x, self.row_ptr)[: self.n]
        return ell_spmm(self.cols, self.vals, x[: self.n])
