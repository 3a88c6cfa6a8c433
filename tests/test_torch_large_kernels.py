"""The large-graph CUDA kernels against their plain PyTorch versions, on
the card (`-m cuda`; they skip without one).

This file imports only the port (no JAX module backed by flax), so it
collects on the machine with the card. The plain versions are held to the
JAX package by `tests/test_torch_spmm.py`, `test_torch_cheb_fused.py` and
`test_torch_large.py` on the CPU. Tolerances: neighbour-max bit-equal;
SpMM rtol 2e-5 / atol 1e-5 (`tests/test_spmm.py`); fused layer within two
bf16 ulps at the layer's scale and a mean relative difference < 1e-3.
Every kernel is deterministic: two launches are bit-equal.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distgcn_tpu_torch import large
from distgcn_tpu_torch.ops import cheb_fused, spmm
from distgcn_tpu_torch.ops.cheb_fused_cuda import fused_cheb_layer_kernel
from distgcn_tpu_torch.ops.lgs import lgs_ranks
from distgcn_tpu_torch.ops.nbr_max_cuda import (bsr_nbr_max_i32_kernel,
                                               bsr_nbr_max_kernel)
from distgcn_tpu_torch.ops.spmm_cuda import bsr_spmm_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pattern(seed, n, m=None, empty=None, span=None, dense=None, bw=160,
             deg=8):
    """Banded random pattern, values in [0.1, 1.1); `empty` a row range
    with no entries (an empty block-row), `span` a row with an entry in
    every 7th column (every 32-column chunk of every block of its
    block-row), `dense` a count d of rows and columns 0..d-1 with every
    cell set (every bitmap word of their 32-row groups full), ragged n
    allowed."""
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    rows = rng.integers(0, n, n * deg)
    cols = (rows + rng.integers(-bw, bw, n * deg)) % m
    s = sp.coo_matrix((rng.random(n * deg).astype(np.float32) + 0.1,
                       (rows, cols)), shape=(n, m)).tocsr()
    if empty is not None or span is not None or dense is not None:
        s = s.tolil()
        if empty is not None:
            s[empty[0]:empty[1], :] = 0
        if span is not None:
            s[span, ::7] = 0.5
        if dense is not None:
            s[:dense, :dense] = 0.5
        s = s.tocsr()
        s.eliminate_zeros()
    return s


CASES = {"ragged": dict(n=1000), "empty_block_row": dict(n=1024,
                                                         empty=(256, 512)),
         "rectangular": dict(n=512, m=1024),
         "spanning_row": dict(n=1024, span=37),
         "dense_block": dict(n=1024, dense=256)}


def _bits(t):
    """A payload's bit pattern: +0.0 and -0.0 differ."""
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bitmap,bs", [(True, 256), (True, 64),
                                       (True, 1024), (False, 128)])
def test_nbr_max_kernel_bit_equal_to_plain(cuda, case, bitmap, bs):
    s = _pattern(1, **CASES[case])
    s.data[:] = 1.0
    b = spmm.BsrMatrix.from_scipy(s, bs, dtype="bits" if bitmap else np.int8,
                                  device=cuda)
    rp = spmm.bsr_row_ptr(b)
    x = torch.randn(b.n_cols, generator=torch.Generator().manual_seed(0))
    x = x.to(cuda)
    before = bsr_nbr_max_kernel.launches
    got = spmm.bsr_neighbor_max(b, x, rp)
    assert bsr_nbr_max_kernel.launches == before + 1
    again = spmm.bsr_neighbor_max(b, x, rp)
    assert bsr_nbr_max_kernel.launches == before + 2
    assert torch.equal(_bits(got), _bits(again))
    want = spmm.bsr_nbr_max_plain(b.blk_vals, rp, b.blk_cols, x, b.n_rows,
                                  bs, bitmap)
    assert torch.equal(_bits(got), _bits(want))
    has = torch.zeros(b.n_rows, dtype=torch.bool, device=cuda)
    has[: s.shape[0]] = torch.from_numpy(np.diff(s.indptr) > 0).to(cuda)
    assert bool((got[~has] == spmm.NEG_HUGE).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bitmap", [True, False])
@pytest.mark.parametrize("bs", [32, 256, 512])
def test_i32_nbr_max_kernel_bit_equal_to_plain(cuda, case, bitmap, bs):
    """The int32 payload: values past f32's integers (2^24 + 1) up to
    2^31 - 2, and -1 (a removed node's rank); empty block-rows and padding
    rows get the int32 sentinel."""
    s = _pattern(4, **CASES[case])
    s.data[:] = 1.0
    b = spmm.BsrMatrix.from_scipy(s, bs, dtype="bits" if bitmap else np.int8,
                                  device=cuda)
    rp = spmm.bsr_row_ptr(b)
    rng = np.random.default_rng(bs)
    x = rng.integers(-1, 2 ** 31 - 1, s.shape[1]).astype(np.int32)
    special = rng.random(x.size) < 0.5
    x[special] = rng.choice(np.array([-1, 1 << 24, (1 << 24) + 1,
                                      2 ** 31 - 2], np.int32), special.sum())
    x = torch.from_numpy(x).to(cuda)
    before = bsr_nbr_max_i32_kernel.launches
    got = spmm.bsr_neighbor_max(b, x, rp)
    assert bsr_nbr_max_i32_kernel.launches == before + 1
    assert torch.equal(got, spmm.bsr_neighbor_max(b, x, rp))
    assert bsr_nbr_max_i32_kernel.launches == before + 2
    assert got.dtype == torch.int32
    xp = torch.cat([x, x.new_full((b.n_cols - x.shape[0],), spmm.I32_SENT)])
    want = spmm.bsr_nbr_max_plain(b.blk_vals, rp, b.blk_cols, xp, b.n_rows,
                                  bs, bitmap)
    assert torch.equal(got, want)
    has = torch.zeros(b.n_rows, dtype=torch.bool, device=cuda)
    has[: s.shape[0]] = torch.from_numpy(np.diff(s.indptr) > 0).to(cuda)
    assert bool((got[~has] == spmm.I32_SENT).all())
    assert bool((got[has] >= -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bitmap", [True, False])
@pytest.mark.parametrize("bs", [32, 256, 1024])
def test_nbr_max_kernel_signed_zero_ties(cuda, bitmap, bs):
    """A payload of +0.0, -0.0 and -1.0: most rows tie at zero, and each
    keeps the first zero in its blocks' order, then its columns' order,
    bit for bit as the plain version does."""
    s = _pattern(7, n=2048, bw=300)
    s.data[:] = 1.0
    b = spmm.BsrMatrix.from_scipy(s, bs, dtype="bits" if bitmap else np.int8,
                                  device=cuda)
    rp = spmm.bsr_row_ptr(b)
    rng = np.random.default_rng(bs)
    x = rng.choice(np.array([0.0, -0.0, -1.0], np.float32), b.n_cols)
    x = torch.from_numpy(x).to(cuda)
    got = spmm.bsr_neighbor_max(b, x, rp)
    want = spmm.bsr_nbr_max_plain(b.blk_vals, rp, b.blk_cols, x, b.n_rows,
                                  bs, bitmap)
    assert torch.equal(_bits(got), _bits(want))
    zero = got == 0
    assert bool(torch.signbit(got[zero]).any())
    assert bool((~torch.signbit(got[zero])).any())


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [64, 256])
def test_kernels_never_read_blocks_past_row_ptr(cuda, bs):
    """A sharded panel pads its block arrays past row_ptr[-1]: padding
    blocks of all-ones words at block column 0 change no result of the
    bitmap neighbour-max (f32 and int32) or SpMM."""
    s = _pattern(8, n=1024)
    s.data[:] = 1.0
    b = spmm.BsrMatrix.from_scipy(s, bs, dtype="bits", device=cuda)
    rp = spmm.bsr_row_ptr(b)
    vals = torch.cat([b.blk_vals, torch.full((4, bs // 32, bs), -1,
                                             dtype=torch.int32,
                                             device=cuda)])
    cols = torch.cat([b.blk_cols, b.blk_cols.new_zeros(4)])
    gen = torch.Generator().manual_seed(bs)
    xf = torch.randn(b.n_cols, generator=gen).to(cuda) + 10.0
    xi = torch.randint(0, 2 ** 31 - 1, (b.n_cols,), generator=gen,
                       dtype=torch.int32).to(cuda)
    for x in (xf, xi):
        got = spmm.nbr_max_rows(vals, rp, cols, x, b.n_rows, bs, True)
        want = spmm.bsr_nbr_max_plain(b.blk_vals, rp, b.blk_cols, x,
                                      b.n_rows, bs, True)
        assert torch.equal(_bits(got), _bits(want))
    x2 = torch.rand((b.n_cols, 128), generator=gen).to(cuda)
    got = spmm.spmm_rows(vals, rp, cols, x2, b.n_rows, bs, True)
    assert torch.equal(got, spmm.spmm_rows(b.blk_vals, rp, b.blk_cols, x2,
                                           b.n_rows, bs, True))
    want = spmm.bsr_spmm_plain(b.blk_vals, rp, b.blk_cols, x2, b.n_rows, bs,
                               True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)
    # the edge form of a weighted copy: padding words of all-ones, values
    # of NaN and run offsets far past the values change nothing
    sw = s.copy()
    sw.data = np.random.default_rng(bs).random(sw.nnz).astype(np.float32)
    ev = spmm.BsrMatrix.from_scipy(sw, bs, device=cuda).edge
    nw = bs // 32
    pad = spmm.EdgeValues(
        torch.cat([ev.words, vals[b.num_blocks:]]),
        torch.cat([ev.vals, torch.full((64,), float("nan"), device=cuda)]),
        torch.cat([ev.off, torch.full((4 * nw,), 1 << 30,
                                      dtype=torch.int32, device=cuda)]))
    got = spmm.edge_spmm_rows(pad, rp, cols, x2, b.n_rows, bs)
    assert torch.equal(got, spmm.edge_spmm_rows(ev, rp, b.blk_cols, x2,
                                                b.n_rows, bs))
    want = spmm.edge_spmm_plain(ev.words, rp, b.blk_cols, ev.vals, ev.off,
                                x2, b.n_rows, bs)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.cuda
def test_i32_nbr_max_kernel_rejects_a_float_payload(cuda):
    s = _pattern(5, n=256)
    s.data[:] = 1.0
    b = spmm.BsrMatrix.from_scipy(s, 256, dtype="bits", device=cuda)
    rp = spmm.bsr_row_ptr(b)
    with pytest.raises(ValueError, match="int32"):
        bsr_nbr_max_i32_kernel(b.blk_vals, rp, b.blk_cols,
                               torch.zeros(256, device=cuda), 256, 256, True)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [32, 256])
def test_sharded_large_solve_on_card_goes_through_the_kernels(cuda, bs,
                                                              monkeypatch):
    """A one-rank ring on the card (no process group): the dqn solve
    equals the single-card exact route (same blocks, same SpMM kernel) and
    the bias-only model (scores = weights) equals `large.bsr_lgs` and the
    CPU run; one int32 and one f32 neighbour-max launch per LGS round and
    one SpMM launch per layer."""
    from distgcn_tpu_torch.parallel.large_sharded import (
        make_sharded_large_solve, shard_arrays, shard_large_graph)
    adj, wts, _ = large.geometric_conflict_graph(4000, avg_degree=24.0,
                                                 seed=7, order="grid")
    sg = shard_large_graph(adj, 1, block_size=bs)
    assert sg.bitmap and sg.separable
    g = large.build_large_graph(adj, block_size=bs, device=cuda)
    w = torch.zeros(sg.n_pad)
    w[: sg.n] = torch.from_numpy(wts)
    gen = torch.Generator().manual_seed(1)
    gcn = {f"gc{i + 1}": {"w_0": torch.randn(fi, fo, generator=gen) * 0.3,
                          "w_1": torch.randn(fi, fo, generator=gen) * 0.3}
           for i, (fi, fo) in enumerate([(1, 32), (32, 32), (32, 1)])}
    bias = {"gc1": {"w_0": torch.zeros(1, 1), "w_1": torch.zeros(1, 1),
                    "bias": torch.ones(1)}}
    kernels = (bsr_nbr_max_i32_kernel, bsr_nbr_max_kernel, bsr_spmm_kernel)

    def run(tree, predict, dev):
        a = shard_arrays(sg, device=dev)
        solve = make_sharded_large_solve(sg, predict=predict, device=dev)
        before = [k.launches for k in kernels]
        sel, util = solve(*a[:4], large.params_to_list(tree, device=dev),
                          w.to(dev), a[4])
        return sel.cpu(), float(util), [k.launches - b
                                        for k, b in zip(kernels, before)]

    sel, util, (i32, f32, spmm_n) = run(gcn, "dqn", cuda)
    assert i32 == f32 > 0 and spmm_n == 3
    monkeypatch.setenv("DISTGCN_LARGE_EXACT", "1")
    xsel, xutil, _ = large.make_large_solve(g, predict="dqn")(
        large.params_to_list(gcn, device=cuda), w.to(cuda))
    assert torch.equal(sel, xsel.cpu())
    assert util == pytest.approx(float(xutil), rel=1e-5)
    sel, util, (i32, f32, spmm_n) = run(bias, "mwis", cuda)
    bsel, butil, rounds = large.bsr_lgs(g, w.to(cuda), g.mask)
    assert torch.equal(sel, bsel.cpu())
    assert i32 == f32 == int(rounds) and spmm_n == 1
    csel, cutil, counts = run(bias, "mwis", torch.device("cpu"))
    assert torch.equal(sel, csel) and counts == [0, 0, 0]
    assert util == pytest.approx(cutil, rel=1e-6)


@pytest.mark.cuda
def test_weighted_sharded_solve_on_card_equals_the_exact_route(cuda):
    """A weighted graph: the one-rank sharded dqn solve (each panel's edge
    form) equals the single-card exact route (the edge form on the same
    256-wide bitmap blocks), one SpMM launch per layer on each."""
    from distgcn_tpu_torch.parallel.large_sharded import (
        make_sharded_large_solve, shard_arrays, shard_large_graph)
    adj, wts, _ = large.geometric_conflict_graph(4000, avg_degree=24.0,
                                                 seed=9, order="grid")
    a = sp.triu(adj, 1).tocsr()
    a.data = np.random.default_rng(9).uniform(0.5, 2.0, a.nnz).astype(
        np.float32)
    adj = (a + a.T).tocsr()
    sg = shard_large_graph(adj, 1, block_size=256)
    g = large.build_large_graph(adj, block_size=256, device=cuda)
    assert sg.bitmap and not sg.separable and not g.separable
    assert g.edge is not None and g.ind_bsr.block_size == 256
    w = torch.zeros(sg.n_pad)
    w[: sg.n] = torch.from_numpy(wts)
    w = w.to(cuda)
    gen = torch.Generator().manual_seed(2)
    tree = {f"gc{i + 1}": {"w_0": torch.randn(fi, fo, generator=gen) * 0.3,
                           "w_1": torch.randn(fi, fo, generator=gen) * 0.3}
            for i, (fi, fo) in enumerate([(1, 32), (32, 32), (32, 1)])}
    plist = large.params_to_list(tree, device=cuda)
    arrays = shard_arrays(sg, device=cuda)
    solve = make_sharded_large_solve(sg, predict="dqn", device=cuda)
    s0 = bsr_spmm_kernel.launches
    sel, util = solve(*arrays[:4], plist, w, arrays[4])
    torch.cuda.synchronize()
    assert bsr_spmm_kernel.launches - s0 == 3
    xsel, xutil, _ = large.make_large_solve(g, predict="dqn")(plist, w)
    torch.cuda.synchronize()
    assert bsr_spmm_kernel.launches - s0 == 6
    assert torch.equal(sel, xsel)
    assert float(util) == pytest.approx(float(xutil), rel=1e-5)
    assert not (sel == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind,bs", [("f32", 128), ("bf16", 64),
                                     ("int8", 128), ("bits", 32),
                                     ("bits", 64), ("bits", 256),
                                     ("bits", 512)])
@pytest.mark.parametrize("f", [1, 6, 24, 128, 160])
def test_spmm_kernel_matches_plain(cuda, case, kind, bs, f):
    """Every kind against its plain version; F of 1, 6 and 24 take the
    bitmap kernel's 1, 2 and 4 features per lane."""
    s = _pattern(2, **CASES[case])
    if kind in ("int8", "bits"):
        s.data[:] = 1.0
    dtype = {"f32": np.float32, "bf16": torch.bfloat16, "int8": np.int8,
             "bits": "bits"}[kind]
    b = spmm.BsrMatrix.from_scipy(s, bs, dtype=dtype, device=cuda)
    rp = spmm.bsr_row_ptr(b)
    x = torch.rand((s.shape[1], f), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    before = bsr_spmm_kernel.launches
    got = spmm.bsr_spmm_rows(b, x, rp)
    assert bsr_spmm_kernel.launches == before + 1
    got_grid = spmm.bsr_spmm(b, x)
    assert bsr_spmm_kernel.launches == before + 2
    xp = torch.cat([x, x.new_zeros((b.n_cols - s.shape[1], f))])
    want = spmm.bsr_spmm_plain(b.blk_vals, rp, b.blk_cols, xp, b.n_rows, bs,
                               b.bitmap)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)
    assert torch.equal(got, got_grid)          # two launches bit-equal
    if kind != "bits":       # raw value blocks: the edge form of this call
        raw = spmm.spmm_rows(b.blk_vals, rp, b.blk_cols, xp, b.n_rows, bs)
        assert bsr_spmm_kernel.launches == before + 3
        assert torch.equal(raw, got)
    if "empty" in case:
        assert not got[256:512].any()
    if case == "spanning_row":                 # every chunk of its row
        assert int(np.diff(s.indptr)[37]) >= s.shape[1] // 7
    if case == "dense_block":                  # 256 full words per group
        assert (np.diff(s.indptr)[:256] >= 256).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [64, 256, 512])
@pytest.mark.parametrize("f", [32, 128, 200])
def test_edge_spmm_kernel_matches_plain(cuda, case, kind, bs, f):
    """The edge form (f32 and bf16 values, int8 structure) from both
    builders against `edge_spmm_plain` and `bsr_spmm_plain` on the value
    blocks; two launches bit-equal."""
    s = _pattern(3, **CASES[case])
    if kind == "int8":
        s.data[:] = 1.0
    dtype = {"f32": np.float32, "bf16": torch.bfloat16,
             "int8": np.int8}[kind]
    b = spmm.BsrMatrix.from_scipy(s, bs, dtype=dtype, device=cuda)
    rp = spmm.bsr_row_ptr(b)
    ind = spmm.BsrMatrix.from_scipy(s, bs, dtype="bits", device=cuda)
    host = spmm.edge_values_coo(s, ind, dtype=dtype) if kind != "int8" \
        else spmm.EdgeValues(ind.blk_vals, None, b.edge.off)
    x = torch.rand((b.n_cols, f), generator=torch.Generator().manual_seed(f))
    x = x.to(cuda)
    before = bsr_spmm_kernel.launches
    got = spmm.edge_spmm_rows(b.edge, rp, b.blk_cols, x, b.n_rows, bs)
    again = spmm.edge_spmm_rows(host, rp, b.blk_cols, x, b.n_rows, bs)
    assert bsr_spmm_kernel.launches == before + 2
    assert torch.equal(got, again)             # two launches bit-equal
    e = b.edge
    want = spmm.edge_spmm_plain(e.words, rp, b.blk_cols, e.vals, e.off, x,
                                b.n_rows, bs)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)
    want = spmm.bsr_spmm_plain(b.blk_vals, rp, b.blk_cols, x, b.n_rows, bs)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)
    if "empty" in case:
        assert not got[256:512].any()


def _fused_inputs(cuda, bitmap, f, seed=3):
    adj, _, _ = large.geometric_conflict_graph(3000, avg_degree=24.0,
                                               seed=seed, order="grid")
    g = large.build_large_graph(adj, block_size=512, device=cuda)
    if not bitmap:                  # the same blocks as an int8 stream
        s = sp.csr_matrix(adj, dtype=np.float32, copy=True)
        s.data[:] = 1.0
        s.resize(g.n_pad, g.n_pad)
        g.ind_bsr = spmm.BsrMatrix.from_scipy(s, 256, dtype=np.int8,
                                              device=cuda)
        g.bitmap = False
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn((g.n_pad, f), generator=gen).to(cuda).to(torch.bfloat16)
    w0 = torch.randn((f, f), generator=gen) * f ** -0.5
    w1 = torch.randn((f, f), generator=gen) * f ** -0.5
    p = cheb_fused.pad_layer_params(
        {"w_0": w0, "w_1": w1, "bias": torch.randn(f, generator=gen) * 0.1},
        f)
    return g, h, {k: v.to(cuda) for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("bitmap", [True, False])
@pytest.mark.parametrize("f", [32, 64, 96, 128])
def test_fused_layer_kernel_matches_plain(cuda, bitmap, f):
    g, h, p = _fused_inputs(cuda, bitmap, f)
    ind = g.ind_bsr
    r = g.r.reshape(-1).contiguous()
    for act, dt in ((1, torch.bfloat16), (0, torch.float32)):
        before = fused_cheb_layer_kernel.launches
        got = cheb_fused.fused_cheb_layer(
            ind.blk_vals, g.ind_row_ptr, ind.blk_cols, h, r, p["w1"],
            p["w01"], p["bias"], ind.n_rows, ind.block_size, act, dt, bitmap)
        assert fused_cheb_layer_kernel.launches == before + 1
        assert torch.equal(got, cheb_fused.fused_cheb_layer(
            ind.blk_vals, g.ind_row_ptr, ind.blk_cols, h, r, p["w1"],
            p["w01"], p["bias"], ind.n_rows, ind.block_size, act, dt,
            bitmap))                     # deterministic: no float atomics
        want = cheb_fused.fused_cheb_layer_plain(
            ind.blk_vals, g.ind_row_ptr, ind.blk_cols, h, r, p["w1"],
            p["w01"], p["bias"], ind.n_rows, ind.block_size, act, dt, bitmap)
        assert got.dtype == want.dtype == dt
        got, want = got.float(), want.float()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2.0 ** -6 * scale
        rel = ((got - want).abs() / (want.abs() + 1e-2)).mean()
        assert float(rel) < 1e-3


def _drop_empty_blocks(b):
    """(blk_vals, row_ptr, blk_cols) of `b` without its all-zero blocks:
    block-rows with no edge get no block at all (row_ptr[i] ==
    row_ptr[i + 1])."""
    keep = b.blk_vals.reshape(b.num_blocks, -1).ne(0).any(dim=1)
    rows = torch.repeat_interleave(torch.arange(b.n_rows // b.block_size,
                                                device=keep.device),
                                   torch.diff(spmm.bsr_row_ptr(b).long()))
    counts = torch.bincount(rows[keep], minlength=b.n_rows // b.block_size)
    row_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    return (b.blk_vals[keep].contiguous(), row_ptr,
            b.blk_cols[keep].contiguous())


# structures of the fused layer's card tests: n_rows not a multiple of the
# kernel's 128-row tile (1056 at bs 32 and 64), and empty block-rows with
# no block at all; the banded pattern leaves whole 32-column k-chunks empty
FUSED_CASES = {"odd_rows": dict(n=1056), "empty_block_rows":
               dict(n=1024, empty=(256, 768))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("bitmap", [True, False])
@pytest.mark.parametrize("bs", [32, 64, 256])
def test_fused_layer_kernel_block_sizes(cuda, case, bitmap, bs):
    """The fused layer over structure blocks of 32, 64 and 256, bitmap and
    int8, against its plain version (same tolerance as
    `test_fused_layer_kernel_matches_plain`); two launches bit-equal."""
    s = _pattern(6, bw=40, **FUSED_CASES[case])
    s.data[:] = 1.0
    b = spmm.BsrMatrix.from_scipy(s, bs, dtype="bits" if bitmap else np.int8,
                                  device=cuda)
    vals, rp, cols = _drop_empty_blocks(b)
    if case == "empty_block_rows":
        assert int((torch.diff(rp) == 0).sum()) >= 512 // bs
    n, f = b.n_rows, 128
    gen = torch.Generator().manual_seed(bs)
    x = torch.randn((n, f), generator=gen).to(cuda).to(torch.bfloat16)
    r = (torch.rand(n, generator=gen) + 0.1).to(cuda)
    p = cheb_fused.pad_layer_params(
        {"w_0": torch.randn((f, f), generator=gen) * f ** -0.5,
         "w_1": torch.randn((f, f), generator=gen) * f ** -0.5,
         "bias": torch.randn(f, generator=gen) * 0.1}, f)
    p = {k: v.to(cuda) for k, v in p.items()}
    args = (vals, rp, cols, x, r, p["w1"], p["w01"], p["bias"], n, bs, 1,
            torch.bfloat16, bitmap)
    before = fused_cheb_layer_kernel.launches
    got = cheb_fused.fused_cheb_layer(*args)
    again = cheb_fused.fused_cheb_layer(*args)
    assert fused_cheb_layer_kernel.launches == before + 2
    assert torch.equal(got, again)
    want = cheb_fused.fused_cheb_layer_plain(*args).float()
    got = got.float()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2.0 ** -6 * scale
    assert float(((got - want).abs() / (want.abs() + 1e-2)).mean()) < 1e-3


@pytest.mark.cuda
def test_fused_layer_kernel_rejects_misaligned_operands(cuda):
    g, h, p = _fused_inputs(cuda, True, 32)
    ind = g.ind_bsr
    r = g.r.reshape(-1).contiguous()
    x = torch.empty(h.numel() + 4, dtype=h.dtype, device=cuda)[4:]
    x = x.view(h.shape).copy_(h)          # 8 bytes past an allocation
    with pytest.raises(ValueError, match="aligned"):
        cheb_fused.fused_cheb_layer(ind.blk_vals, g.ind_row_ptr,
                                    ind.blk_cols, x, r, p["w1"], p["w01"],
                                    p["bias"], ind.n_rows, ind.block_size, 1,
                                    torch.bfloat16, True)


@pytest.mark.cuda
def test_large_solve_on_card_goes_through_the_kernels(cuda, monkeypatch):
    adj, wts, _ = large.geometric_conflict_graph(4000, avg_degree=24.0,
                                                 seed=5, order="grid")
    g = large.build_large_graph(adj, block_size=512, device=cuda)
    assert g.use_bsr and g.bitmap
    gen = torch.Generator().manual_seed(0)
    tree = {f"gc{i + 1}": {"w_0": torch.randn(fi, fo, generator=gen) * 0.3,
                           "w_1": torch.randn(fi, fo, generator=gen) * 0.3}
            for i, (fi, fo) in enumerate([(1, 32), (32, 32), (32, 1)])}
    plist = large.params_to_list(tree, device=cuda)
    w = torch.zeros(g.n_pad)
    w[: g.n] = torch.from_numpy(wts)
    w = w.to(cuda)
    solve = large.make_large_solve(g, predict="dqn")
    f0 = fused_cheb_layer_kernel.launches
    sel, util, _ = solve(plist, w)
    torch.cuda.synchronize()
    assert fused_cheb_layer_kernel.launches - f0 == 3
    m = g.mask.to(torch.float32)
    gcn_wts = large.large_gcn_forward(
        g, plist, large._features(g, w, m, 1, "dqn"))[:, 0] * m
    n0, e0 = bsr_nbr_max_kernel.launches, large.bsr_lgs.rounds_enqueued
    bsel, _, rounds = large.bsr_lgs(g, gcn_wts, g.mask)
    enqueued = large.bsr_lgs.rounds_enqueued - e0
    assert bsr_nbr_max_kernel.launches - n0 == 2 * enqueued
    assert enqueued >= int(rounds) > 0
    ge = large.build_large_graph(adj, block_size=512, use_bsr=False,
                                 device=cuda)
    assert g.ell_cols is None and ge.ind_bsr is None
    esel = large.ell_lgs(ge.ell_cols, ge.ell_valid, gcn_wts, g.mask)[0]
    assert torch.equal(bsel, esel) and torch.equal(bsel, sel)
    # the exact route: one SpMM launch per layer
    s0 = bsr_spmm_kernel.launches
    monkeypatch.setenv("DISTGCN_LARGE_EXACT", "1")
    _, xutil, _ = solve(plist, w)
    torch.cuda.synchronize()
    assert bsr_spmm_kernel.launches - s0 == 3
    assert abs(float(util) - float(xutil)) <= 0.01 * abs(float(xutil))


_LGS_GRAPHS = {}


def _lgs_graph(cuda, n, bs, isolated):
    """A geometric graph of n links on blocks of `bs` (every 9th link
    isolated if asked) on the BSR and on the ELL route, built once per
    (n, bs, isolated)."""
    key = (n, bs, isolated)
    if key not in _LGS_GRAPHS:
        adj, wts, _ = large.geometric_conflict_graph(
            n, avg_degree=48.0 if n > 10000 else 12.0, seed=n, order="grid")
        if isolated:
            keep = np.arange(n) % 9 != 0
            adj = sp.csr_matrix(adj.multiply(keep[:, None]).multiply(keep))
            adj.eliminate_zeros()
        g = large.build_large_graph(adj, block_size=bs, device=cuda)
        assert g.bitmap and g.ind_bsr.block_size == bs
        ge = large.build_large_graph(adj, block_size=bs, use_bsr=False,
                                     device=cuda)
        w = torch.zeros(g.n_pad)
        w[:n] = torch.from_numpy(wts)
        _LGS_GRAPHS[key] = (g, ge, w.to(cuda))
    return _LGS_GRAPHS[key]


def _batches(first, cap, rounds):
    """(reads, rounds enqueued) of a `bsr_lgs` solve of `rounds` rounds
    whose first batch is `first`, by `large.lgs_batches`."""
    reads = enqueued = 0
    for k in large.lgs_batches(first, cap) if rounds else ():
        reads, enqueued = reads + 1, enqueued + k
        if enqueued >= rounds:
            break
    return reads, enqueued


def _plain_lgs(g, wts, mask, max_rounds=None):
    """The LGS rounds composed from `bsr_nbr_max_plain` and element-wise
    ops: two neighbour-maxes a round and a host test of the nodes left."""
    ind = g.ind_bsr
    ranks = lgs_ranks(wts).to(torch.float32)
    sel = torch.where(mask, -1, 0).to(torch.int8)
    cap = wts.shape[0] if max_rounds is None else max_rounds

    def nbr_max(x):
        return spmm.bsr_nbr_max_plain(ind.blk_vals, g.ind_row_ptr,
                                      ind.blk_cols, x, ind.n_rows,
                                      ind.block_size, True)

    r = 0
    while r < cap and bool((sel == -1).any()):
        remain = sel == -1
        win = remain & (ranks > nbr_max(torch.where(remain, ranks, -1.0)))
        hit = nbr_max(win.to(torch.float32)) > 0.0
        sel = torch.where(win, torch.ones_like(sel), sel)
        sel = torch.where(remain & ~win & hit, torch.zeros_like(sel), sel)
        r += 1
    return sel, torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(), r


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "ties", "max_rounds", "isolated",
                                  "masked", "zero_weights"])
@pytest.mark.parametrize("bs", [256, 128])
@pytest.mark.parametrize("n", [300, 5000, 65536])
def test_bsr_lgs_rounds_bit_equal_to_plain_composition(cuda, n, bs, case):
    """`large.bsr_lgs` (each round B2's rank and spread passes, enqueued
    in batches with one read each) against the rounds composed from the
    plain neighbour-max and against `ell_lgs`: sel, util and rounds
    bit-equal, two launches a round enqueued, and the rounds enqueued past
    the last (gated) those of the batch rule. 300 and 5,000 links leave
    padding rows without neighbours."""
    g, ge, w = _lgs_graph(cuda, n, bs, case == "isolated")
    mask, max_rounds = g.mask, None
    if case == "ties":
        w = torch.round(w * 4) / 4
    elif case == "max_rounds":
        max_rounds = 2
    elif case == "masked":
        mask = g.mask & (torch.arange(g.n_pad, device=cuda) % 5 != 0)
    elif case == "zero_weights":
        w = torch.zeros_like(w)
    state = g.lgs_state
    first = (large.LGS_FIRST if state is None or state.rounds is None
             else state.rounds + 1)
    n0 = bsr_nbr_max_kernel.launches
    r0, e0 = large.bsr_lgs.reads, large.bsr_lgs.rounds_enqueued
    sel, util, rounds = large.bsr_lgs(g, w, mask, max_rounds)
    torch.cuda.synchronize()
    enqueued = large.bsr_lgs.rounds_enqueued - e0
    assert bsr_nbr_max_kernel.launches - n0 == 2 * enqueued > 0
    cap = w.shape[0] if max_rounds is None else max_rounds
    assert ((large.bsr_lgs.reads - r0, enqueued)
            == _batches(first, cap, int(rounds)))
    assert int(rounds) <= enqueued <= cap
    psel, putil, prounds = _plain_lgs(g, w, mask, max_rounds)
    assert sel.dtype == torch.int8 and torch.equal(sel, psel)
    assert int(rounds) == prounds
    assert torch.equal(util.view(torch.int32), putil.view(torch.int32))
    esel, _, erounds = large.ell_lgs(ge.ell_cols, ge.ell_valid, w, mask,
                                     max_rounds)
    assert torch.equal(sel, esel) and int(erounds) == prounds
    assert not sel[~mask].any()
    if max_rounds is None:
        assert not (sel[mask] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [256, 128])
def test_gated_lgs_kernel_pass_writes_nothing(cuda, bs):
    """B2's rank and spread passes with the previous count 0 leave key,
    win and sel as they were (bits), and of the counts only the rank
    pass's zeroed slot differs; open, each pass is bit-equal to its plain
    version on the same state."""
    g, _, w = _lgs_graph(cuda, 5000, bs, False)
    ind = g.ind_bsr
    gen = torch.Generator(device=cuda).manual_seed(3)
    key = lgs_ranks(w).to(torch.float32)
    key[torch.rand(g.n_pad, generator=gen, device=cuda) < 0.3] = -1.0
    win = (torch.rand(g.n_pad, generator=gen, device=cuda)
           < 0.2).to(torch.float32)
    sel = torch.where(key >= 0, -1, 0).to(torch.int8)
    left = torch.tensor([0, 7, 9, 11], dtype=torch.int32, device=cuda)

    def passes(state, counts, on):
        return spmm.lgs_round_passes(ind.blk_vals.to(on),
                                     g.ind_row_ptr.to(on),
                                     ind.blk_cols.to(on), *state, counts,
                                     ind.n_rows, ind.block_size, True)

    state = [key, win, sel]
    kernel = passes(state, left, cuda)
    was = [t.clone() for t in state]
    n0 = bsr_nbr_max_kernel.launches
    kernel[0](0, 1)
    kernel[1](0, 2)
    torch.cuda.synchronize()
    assert bsr_nbr_max_kernel.launches - n0 == 2
    for got, before in zip(state, was):
        assert torch.equal(_bits(got) if got.is_floating_point() else got,
                           _bits(before) if got.is_floating_point()
                           else before)
    assert left.tolist() == [0, 0, 9, 11]
    plain_state = [t.cpu() for t in state]
    plain_left = left.cpu()
    plain = passes(plain_state, plain_left, "cpu")
    for i in range(2):                       # open: left[2] = 9
        kernel[i](2, 3)
        plain[i](2, 3)
        torch.cuda.synchronize()
        for got, want in zip(state, plain_state):
            assert torch.equal(got.cpu(), want)
        assert left.tolist() == plain_left.tolist()
    assert not all(torch.equal(got, before) for got, before in zip(state,
                                                                   was))
