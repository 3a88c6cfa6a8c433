"""The FLOP and byte counts against hand counts at tiny shapes."""

import numpy as np
import pytest
import scipy.sparse as sp

from bench_h100.counts import gcn, kernels, peaks


def test_layer_and_forward_flops():
    # 3 links, 4 directed edges, 2 -> 5: 2*2*3*2*5 + 2*4*5
    assert gcn.layer_flops(3, 4, 2, 5) == 120 + 40
    dims = gcn.widths(1, 32, 3)
    assert dims == [1, 32, 32, 1]
    assert gcn.forward_flops(3, 4, dims) == (
        (4 * 3 * 1 * 32 + 2 * 4 * 32) + (4 * 3 * 32 * 32 + 2 * 4 * 32)
        + (4 * 3 * 32 * 1 + 2 * 4 * 1))


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, f32_ops=67e12, bf16_ops=989e12) \
        == pytest.approx(2.0)


def test_lgs_bytes():
    # B=2, N=4: adjacency 2*16, weights+mask+sel 2*4*6, util+rounds 2*8
    assert kernels.lgs_bound_s(2, 4) * peaks.HBM_BYTES == pytest.approx(96)
    # the dense cell's shape, as phase 5 of chip_smoke.py counted it
    assert kernels.lgs_bound_s(128, 256) * peaks.HBM_BYTES \
        == pytest.approx(8_586_240)


def test_structure_blocks_and_bytes():
    n = 512
    rows = np.array([0, 1, 300, 511])
    cols = np.array([1, 0, 10, 300])
    adj = sp.coo_matrix((np.ones(4), (rows, cols)), shape=(n, n))
    # blocks (0,0), (1,0), (1,1)
    assert kernels.structure_blocks(adj) == 3
    assert kernels.structure_bytes(3, n) == 3 * 8192 + 3 * 4 + 3 * 4


def test_kernel_bounds_at_tiny_shapes():
    blocks, n, nnz = 2, 512, 100
    st = 2 * 8192 + 3 * 4 + 2 * 4
    assert kernels.nbr_max_bound_s(blocks, n, nnz) * peaks.HBM_BYTES \
        == pytest.approx(st + 2 * n * 4)
    fb = st + n * 32 * 2 + n * 32 * 2 + n * 4 + 2 * 32 * 32 * 4 + 32 * 4
    assert kernels.fused_layer_bound_s(blocks, n, nnz, 32, 32, False) \
        == pytest.approx(max(fb / peaks.HBM_BYTES,
                             4 * n * 32 * 32 / peaks.F32_FLOPS
                             + 2 * nnz * 32 / peaks.BF16_FLOPS))
    head = st + n * 32 * 2 + n * 1 * 4 + n * 4 + 2 * 32 * 4 + 4
    assert kernels.fused_layer_bound_s(blocks, n, nnz, 32, 1, True) \
        * peaks.HBM_BYTES == pytest.approx(head)
    eb = st + nnz * 4 + (2 * 8 + 1) * 4 + 2 * n * 32 * 4
    assert kernels.edge_spmm_bound_s(blocks, n, nnz, 32) * peaks.HBM_BYTES \
        == pytest.approx(eb)
