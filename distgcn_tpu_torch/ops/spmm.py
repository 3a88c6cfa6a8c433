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
- `EdgeValues`: the edge form of a weighted (or int8) matrix, the bitmap
  of its structure plus its nonzero values in the order the SpMM kernel
  meets the set bits. `edge_values` builds it from value or int8 blocks,
  `edge_values_coo` from COO aligned to a bitmap `BsrMatrix`;
  `BsrMatrix.from_scipy` builds it once beside value and int8 blocks.
- `bsr_spmm_rows` / `bsr_spmm` (y = S @ x, the counterparts of the JAX
  row-grid and block-grid SpMMs; value and int8 kinds through the edge
  form, `edge_spmm_rows`) and `bsr_neighbor_max`
  (y[i] = max over structural neighbours j of x[j]) run their plain
  PyTorch versions on CPU tensors and the hand-written CUDA kernels
  (`ops/spmm_cuda.py`, `ops/nbr_max_cuda.py`) on CUDA tensors.
  `lgs_round_passes` gives a large LGS round's two neighbour-maxes with
  the round's logic after each: one launch each over bitmap blocks on
  the card, the plain composition otherwise.
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
    (row, col). ``edge``: the edge form of value and int8 blocks (the
    operand of the SpMM), built by `from_scipy`."""
    blk_vals: torch.Tensor
    blk_rows: torch.Tensor
    blk_cols: torch.Tensor
    n_rows: int             # padded row count (multiple of bs)
    n_cols: int
    block_size: int
    nb_real: int = 0
    bitmap: bool = False
    edge: Optional["EdgeValues"] = None

    @classmethod
    def from_scipy(cls, s: sp.spmatrix, block_size: int = 128,
                   dtype=np.float32, device=None) -> "BsrMatrix":
        """Build from scipy. ``dtype``: a numpy dtype for value or int8
        structure blocks, ``torch.bfloat16`` for bf16 value blocks, or
        ``"bits"`` for bitmap structure blocks packed from COO (the dense
        int8 stream is never built). Value and int8 blocks get their edge
        form (`edge_values`) beside them."""
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
        m = cls(vals.to(dev), torch.from_numpy(rows).to(dev),
                torch.from_numpy(cols).to(dev), nr, nc, bs, nb_real=nb,
                bitmap=bitmap)
        if not bitmap:
            m.edge = edge_values(m.blk_vals, bsr_row_ptr(m))
        return m

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
# the edge form: the structure bitmap plus per-edge values
# ---------------------------------------------------------------------------

@dataclass
class EdgeValues:
    """A block-sparse matrix as the bitmap of its structure and its nonzero
    values, beside the blocks' ``row_ptr`` and ``blk_cols``.

    - ``words``: int32 [nb, nw, bs] with nw = ceil(bs / 32), the
      `pack_bits_blocks` layout (bit i % 32 of word [i // 32, j] = cell
      (i, j)). The plain version also takes int8 0/1 cells [nb, bs, bs]
      here (a structure of a block size that is no multiple of 32).
    - ``vals``: [nnz] f32 or bf16, or None for a 0/1 structure. Ordered by
      (block, word-row g, column c, bit b): the order in which a warp of
      the SpMM kernel meets the set bits of its 32-row group.
    - ``off``: int32 [nb * nw + 1]; the values of run (block k, word-row
      g) start at ``off[k * nw + g]``, and a word's first value sits
      there plus the popcounts of the run's earlier words. Blocks past
      ``row_ptr[-1]`` have empty runs.
    """
    words: torch.Tensor
    vals: Optional[torch.Tensor]
    off: torch.Tensor


def _walk_bits(struct: torch.Tensor, bs: int) -> torch.Tensor:
    """Bitmap words [nb, nw, bs] or 0/1 cells [nb, bs, bs] -> bool
    [nb, nw, bs, 32] indexed (block, word-row g, column c, bit b): the
    edge form's value order."""
    if struct.dtype == torch.int32:
        shifts = torch.arange(32, dtype=torch.int32, device=struct.device)
        return ((struct[..., None] >> shifts) & 1).bool()
    return _cells_by_word(struct != 0, bs)


def _cells_by_word(cells: torch.Tensor, bs: int) -> torch.Tensor:
    """[nb, bs, bs] cells -> [nb, nw, bs, 32] (rows past bs: zero)."""
    nb, nw = cells.shape[0], -(-bs // 32)
    if nw * 32 != bs:
        cells = torch.cat([cells, cells.new_zeros((nb, nw * 32 - bs, bs))],
                          dim=1)
    return cells.reshape(nb, nw, 32, bs).transpose(2, 3)


def edge_values(blocks: torch.Tensor, row_ptr: torch.Tensor) -> EdgeValues:
    """The torch builder: the edge form of value (f32/bf16) or int8
    structure blocks [nb, bs, bs] sorted by block-row (``row_ptr``), on
    the blocks' device. Blocks past ``row_ptr[-1]`` give zero words and
    empty runs."""
    nb, bs = blocks.shape[0], blocks.shape[-1]
    live = torch.arange(nb, device=blocks.device) < row_ptr[-1].to(
        blocks.device)
    bits = _cells_by_word((blocks != 0) & live[:, None, None], bs)
    shifts = torch.arange(32, dtype=torch.int64, device=blocks.device)
    w = (bits.to(torch.int64) << shifts).sum(-1)
    words = torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
    vals = None
    if blocks.dtype != torch.int8:
        vals = _cells_by_word(blocks, bs)[bits].contiguous()
    counts = bits.sum((2, 3)).reshape(-1)
    off = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    return EdgeValues(words.contiguous(), vals, off)


def edge_runs(blk: np.ndarray, lrow: np.ndarray, lcol: np.ndarray,
              data: np.ndarray, bs: int, nb: int):
    """Host: (values in edge-form order, int32 off [nb * nw + 1]) of the
    edges at block `blk`, row `lrow` and column `lcol` within it."""
    nw = -(-bs // 32)
    run = blk.astype(np.int64) * nw + lrow // 32
    order = np.lexsort((lrow % 32, lcol, run))
    off = np.zeros(nb * nw + 1, np.int64)
    np.cumsum(np.bincount(run, minlength=nb * nw), out=off[1:])
    return data[order], off.astype(np.int32)


def edge_values_coo(s: sp.spmatrix, ind: "BsrMatrix",
                    dtype=np.float32) -> EdgeValues:
    """The host builder: the edge form of `s` on the structure blocks of
    `ind` (bitmap, or int8 for a block size that is no multiple of 32),
    which hold one cell for every stored entry of `s`, explicit zeros
    included. ``words`` is ``ind.blk_vals`` itself; ``vals`` are f32, or
    bf16 for ``dtype=torch.bfloat16``, on ind's device."""
    coo = sp.csr_matrix(s, copy=True)
    coo.sum_duplicates()
    coo = coo.tocoo()
    bs = ind.block_size
    nbc = ind.n_cols // bs
    bkeys = (ind.blk_rows.cpu().numpy().astype(np.int64) * nbc
             + ind.blk_cols.cpu().numpy())
    ekeys = (coo.row // bs).astype(np.int64) * nbc + coo.col // bs
    blk = np.searchsorted(bkeys, ekeys)
    if coo.nnz and (blk.max() >= bkeys.size
                    or not np.array_equal(bkeys[blk], ekeys)):
        raise ValueError("an entry of s lies outside ind's blocks")
    vals, off = edge_runs(blk, coo.row % bs, coo.col % bs,
                          coo.data.astype(np.float32), bs, ind.num_blocks)
    v = torch.from_numpy(vals)
    if dtype is torch.bfloat16:
        v = v.to(torch.bfloat16)
    dev = ind.blk_vals.device
    return EdgeValues(ind.blk_vals, v.to(dev), torch.from_numpy(off).to(dev))


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


def edge_spmm_plain(words: torch.Tensor, row_ptr: torch.Tensor,
                    blk_cols: torch.Tensor, vals: Optional[torch.Tensor],
                    off: torch.Tensor, x: torch.Tensor, n_rows: int,
                    block_size: int) -> torch.Tensor:
    """Plain PyTorch y = S @ x over the edge form (`EdgeValues`' fields;
    ``vals`` None for a 0/1 structure): f32 [n_rows, F], 0 on rows with no
    edge. Each edge's value is read at ``off[run]`` plus its rank in the
    run, as the kernel reads it, and each row sums its edges in the
    kernel's order (blocks in row_ptr order, columns ascending). Blocks
    past ``row_ptr[-1]`` are never read. x: [n_cols, F] f32."""
    bs = block_size
    nw = -(-bs // 32)
    words, blk_cols = _addressed(row_ptr, words, blk_cols)
    k, g, c, b = _walk_bits(words, bs).nonzero(as_tuple=True)
    run = k * nw + g
    counts = torch.bincount(run, minlength=words.shape[0] * nw)
    rank = torch.arange(run.numel(), device=x.device) - (
        counts.cumsum(0) - counts)[run]
    v = (torch.ones_like(rank, dtype=torch.float32) if vals is None
         else vals[off[run].long() + rank].to(torch.float32))
    rows = _block_rows(row_ptr)[k] * bs + g * 32 + b
    cols = blk_cols[k].long() * bs + c
    y = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    return y.index_add_(0, rows, v[:, None] * x[cols].to(torch.float32))


def edge_spmm_rows(ev: EdgeValues, row_ptr: torch.Tensor,
                   blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
                   block_size: int) -> torch.Tensor:
    """y = S @ x over the edge form: the plain version for CPU tensors, the
    SpMM kernel (one multiply per set bit) for CUDA tensors, which
    launches without synchronising. x: [n_cols, F] f32."""
    if x.device.type == "cpu":
        return edge_spmm_plain(ev.words, row_ptr, blk_cols, ev.vals, ev.off,
                               x, n_rows, block_size)
    from distgcn_tpu_torch.ops.spmm_cuda import bsr_spmm_kernel
    return bsr_spmm_kernel(ev.words, row_ptr, blk_cols, x, n_rows,
                           block_size, True, ev.vals, ev.off)


def spmm_rows(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
              blk_cols: torch.Tensor, x: torch.Tensor, n_rows: int,
              block_size: int, bitmap: bool = False) -> torch.Tensor:
    """y = S @ x on raw block arrays (the JAX `_bsr_spmm_rows`): the plain
    version for CPU tensors, the SpMM kernel for CUDA tensors (value and
    int8 blocks through their edge form, built for this call). Blocks
    past ``row_ptr[-1]`` are never read. x: [n_cols, F] f32."""
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
    (int8/bitmap) blocks, value and int8 kinds through their edge form;
    block-rows with no block give 0. Pass a
    precomputed `row_ptr` (`bsr_row_ptr`) to save its host-side build.
    Returns [n_rows, F] f32. On CUDA tensors this launches the SpMM kernel
    without synchronising."""
    if row_ptr is None:
        row_ptr = bsr_row_ptr(s)
    x = _pad_rows(x, s.n_cols)
    if s.edge is not None:
        return edge_spmm_rows(s.edge, row_ptr, s.blk_cols, x, s.n_rows,
                              s.block_size)
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


def lgs_round_passes(blk_vals: torch.Tensor, row_ptr: torch.Tensor,
                     blk_cols: torch.Tensor, key: torch.Tensor,
                     win: torch.Tensor, sel: torch.Tensor, left: torch.Tensor,
                     n_rows: int, block_size: int, bitmap: bool = False):
    """A large LGS round (`large.bsr_lgs`) as two passes over the
    structure blocks, each a neighbour-max with the round's logic after
    it, in place on the round's state: key (f32 [n_rows], a node's rank
    while undecided, -1 once decided), win (f32 [n_rows]), sel (int8
    [n_rows]: -1 undecided, 1 selected, 0 excluded) and left (int32
    [>= 2], the rounds' counts of nodes left). Returns (rank_pass,
    spread_pass), callables of (prev, cur): the slots of left that hold
    the previous round's count (or any nonzero value before the first
    round) and this round's. Where left[prev] is 0 the round is gated: it
    changes nothing but left[cur] = 0, so the rounds after it stay gated.

    - rank_pass: left[cur] = 0; unless gated, with m the neighbour-max of
      key, win[i] = 1.0 where key[i] >= 0 and key[i] > m[i], else 0.0 (a
      decided row without neighbours, m the sentinel, does not win);
    - spread_pass, unless gated: a row with win set gets sel = 1, an
      undecided row with a neighbour whose win is set gets sel = 0, both
      get key = -1; left[cur] = the rows still undecided.

    Bitmap blocks on CUDA tensors: one launch of the neighbour-max kernel
    each (`ops.nbr_max_cuda.lgs_round_kernels`, checked once here); else
    the plain composition over `nbr_max_rows`, its gate on the device as
    the kernels' is (no host read)."""
    if key.is_cuda and bitmap:
        from distgcn_tpu_torch.ops.nbr_max_cuda import lgs_round_kernels
        return lgs_round_kernels(blk_vals, row_ptr, blk_cols, key, win, sel,
                                 left, n_rows, block_size)

    def nbr_max(x):
        return nbr_max_rows(blk_vals, row_ptr, blk_cols, x, n_rows,
                            block_size, bitmap)

    def rank_pass(prev: int, cur: int):
        go = left[prev] > 0
        won = (key >= 0) & (key > nbr_max(key))
        win.copy_(torch.where(go, won.to(win.dtype), win))
        left[cur] = 0

    def spread_pass(prev: int, cur: int):
        go = left[prev] > 0
        hit = nbr_max(win) > 0.0
        won = (win > 0.0) & go
        out = ~won & (key >= 0) & hit & go
        sel.masked_fill_(won, 1).masked_fill_(out, 0)
        key.masked_fill_(won | out, -1.0)
        left[cur] = torch.where(go, (key >= 0).sum().to(left.dtype),
                                left[cur])

    return rank_pass, spread_pass


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
    """Sparse support matrix: BSR SpMM kernel on a CUDA device (over the
    edge form of its f32 value blocks, built once here), ELL gather on the
    CPU."""

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
