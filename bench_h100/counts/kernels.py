"""Bytes and operations of one launch of each hand-written kernel, from
the shapes of the call: each input byte read once, each output byte
written once, operations at the real (unpadded) widths.

Bitmap structure blocks are 256 x 256 links, 8 rows of 32-bit words per
block row of 256 (8,192 bytes a block), with an int32 block-row pointer
and an int32 block column per block; `structure_blocks` counts the blocks
that hold a conflict.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from bench_h100.counts import peaks

BS = 256                                   # structure block width
BLOCK_BYTES = BS * (BS // 32) * 4          # bitmap words of one block


def structure_blocks(adj: sp.spmatrix, bs: int = BS) -> int:
    c = sp.coo_matrix(adj)
    nbr = (c.shape[1] + bs - 1) // bs
    return int(np.unique((c.row // bs).astype(np.int64) * nbr
                         + c.col // bs).size)


def structure_bytes(blocks: int, n_pad: int) -> int:
    return blocks * BLOCK_BYTES + (n_pad // BS + 1) * 4 + blocks * 4


def lgs_bound_s(batch: int, n: int) -> float:
    """B1 (`csrc/lgs.cu`): adjacency [B, N, N] bytes, f32 weights, mask
    in; sel out; util and rounds per graph."""
    return peaks.bound_s(batch * n * n + batch * n * (4 + 1 + 1)
                         + batch * (4 + 4))


def nbr_max_bound_s(blocks: int, n_pad: int, nnz: int) -> float:
    """B2 (`csrc/bsr_nbr_max.cu`, bitmap): the structure, x and y f32."""
    return peaks.bound_s(structure_bytes(blocks, n_pad) + 2 * n_pad * 4,
                         f32_ops=nnz)


def fused_layer_bound_s(blocks: int, n_pad: int, nnz: int, fin: int,
                        fout: int, head: bool) -> float:
    """B3 (`csrc/cheb_fused.cu`): the structure, bf16 x [n, Fin], r, W1
    and W0+W1, the bias in; y [n, Fout] out (bf16, the head f32); W
    products in f32, the A-product in bf16."""
    nbytes = (structure_bytes(blocks, n_pad) + n_pad * fin * 2
              + n_pad * fout * (4 if head else 2) + n_pad * 4
              + 2 * fin * fout * 4 + fout * 4)
    return peaks.bound_s(nbytes, f32_ops=4 * n_pad * fin * fout,
                         bf16_ops=2 * nnz * fin)


def edge_spmm_bound_s(blocks: int, n_pad: int, nnz: int, f: int) -> float:
    """B4b (`csrc/bsr_spmm.cu`, edge form): the structure, one f32 value
    per edge, an int32 offset per (block, word row) run, x and y f32."""
    nbytes = (structure_bytes(blocks, n_pad) + nnz * 4
              + (blocks * (BS // 32) + 1) * 4 + 2 * n_pad * f * 4)
    return peaks.bound_s(nbytes, f32_ops=2 * nnz * f)
