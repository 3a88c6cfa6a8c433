"""Port parity: BSR builders, neighbour-max and SpMM against the JAX
package's `ops/spmm.py` (Pallas in interpret mode, XLA ELL) and scipy.

Builders and neighbour-max are exact and must be bit-equal; the SpMM sums
in another order and is held to `tests/test_spmm.py`'s rtol 2e-5 /
atol 1e-5. The CUDA kernels themselves run only on the card
(`tests/test_torch_large_kernels.py`, `-m cuda`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distgcn_tpu.ops import spmm as J
from distgcn_tpu_torch.ops import spmm as T
from distgcn_tpu_torch.ops.nbr_max_cuda import bsr_nbr_max_kernel
from distgcn_tpu_torch.ops.spmm_cuda import bsr_spmm_kernel


def _banded(rng, n=600, deg=6, bw=96, empty=None, m=None):
    """Banded random pattern with random values; `empty` a row range left
    without entries (an empty block-row), `m` a column count
    (rectangular)."""
    m = n if m is None else m
    nnz = n * deg
    rows = rng.integers(0, n, nnz)
    cols = (rows + rng.integers(-bw, bw, nnz)) % m
    s = sp.coo_matrix((rng.random(nnz).astype(np.float32) + 0.1,
                       (rows, cols)), shape=(n, m)).tocsr()
    if empty is not None:
        s = s.tolil()
        s[empty[0]:empty[1], :] = 0
        s = s.tocsr()
        s.eliminate_zeros()
    return s


def _structure(s):
    s = s.copy()
    s.data[:] = 1.0
    return s


CASES = {
    "square": dict(n=600),
    "empty_block_row": dict(n=640, empty=(128, 256)),
    "rectangular": dict(n=256, m=512),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_bsr_from_scipy_matches_jax(case, dtype):
    rng = np.random.default_rng(1)
    s = _banded(rng, **CASES[case])
    if dtype == np.int8:
        s = _structure(s)
    jb = J.BsrMatrix.from_scipy(s, 128, dtype=dtype)
    tb = T.BsrMatrix.from_scipy(s, 128, dtype=dtype, device="cpu")
    nb = jb.nb_real
    assert tb.nb_real == tb.num_blocks == nb
    assert (tb.n_rows, tb.n_cols, tb.block_size) == (jb.n_rows, jb.n_cols,
                                                     128)
    np.testing.assert_array_equal(tb.blk_vals.numpy(),
                                  np.asarray(jb.blk_vals)[:nb])
    np.testing.assert_array_equal(tb.blk_rows.numpy(),
                                  np.asarray(jb.blk_rows)[:nb])
    np.testing.assert_array_equal(tb.blk_cols.numpy(),
                                  np.asarray(jb.blk_cols)[:nb])
    # the JAX row pointer also counts the chunk padding, in its last entry
    rp = T.bsr_row_ptr(tb)
    assert rp.dtype == torch.int32 and int(rp[-1]) == nb
    np.testing.assert_array_equal(rp.numpy()[:-1],
                                  np.asarray(J.bsr_row_ptr(jb))[:-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_bitmap_from_coo_equals_pack_bits_of_int8(case):
    rng = np.random.default_rng(2)
    s = _structure(_banded(rng, **CASES[case]))
    tb8 = T.BsrMatrix.from_scipy(s, 64, dtype=np.int8, device="cpu")
    tbb = T.BsrMatrix.from_scipy(s, 64, dtype="bits", device="cpu")
    assert tbb.bitmap and not tb8.bitmap
    assert tbb.blk_vals.dtype == torch.int32
    np.testing.assert_array_equal(tbb.blk_vals.numpy(),
                                  T.pack_bits_blocks(tb8.blk_vals.numpy()))
    np.testing.assert_array_equal(T.pack_bits_blocks(tb8.blk_vals.numpy()),
                                  J.pack_bits_blocks(tb8.blk_vals.numpy()))
    torch.testing.assert_close(T.unpack_bits(tbb.blk_vals, 64),
                               tb8.blk_vals != 0)
    np.testing.assert_array_equal(tbb.blk_rows.numpy(),
                                  tb8.blk_rows.numpy())


def test_ell_pack_and_ell_spmm_match_jax(rng):
    s = _banded(rng, n=300)
    cols, vals = T.ell_pack(s)
    jcols, jvals = J.ell_pack(s)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(vals, jvals)
    x = rng.random((300, 16)).astype(np.float32)
    y = T.ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals),
                   torch.from_numpy(x)).numpy()
    jy = np.asarray(J.ell_spmm(jnp.asarray(cols), jnp.asarray(vals),
                               jnp.asarray(x)))
    np.testing.assert_allclose(y, jy, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(y, s @ x, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bitmap", [False, True])
def test_neighbor_max_bit_equal_to_jax(case, bitmap):
    rng = np.random.default_rng(3)
    s = _structure(_banded(rng, **CASES[case]))
    n, m = s.shape
    jb = J.BsrMatrix.from_scipy(s, 128, dtype=np.int8)
    tb = T.BsrMatrix.from_scipy(s, 128, dtype="bits" if bitmap else np.int8,
                                device="cpu")
    x = rng.standard_normal(m).astype(np.float32)
    got = T.bsr_neighbor_max(tb, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (jb.n_rows,)
    xp = np.full(jb.n_cols, J._NEG_HUGE, np.float32)
    xp[:m] = x
    xj = jnp.asarray(xp)
    rows = np.asarray(J._bsr_nbr_max_rows(
        jb.blk_vals, J.bsr_row_ptr(jb), jb.blk_cols, xj, jb.n_rows, 128,
        interpret=True))
    chunks = np.asarray(J._bsr_nbr_max_chunks(
        jb.blk_vals, jb.blk_rows, jb.blk_cols, xj, jb.n_rows, 128,
        interpret=True))
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(got, chunks)
    # the block grid leaves rows of empty block-rows unset: compare the rest
    grid = np.asarray(J.bsr_neighbor_max(jb, jnp.asarray(x), interpret=True))
    has = np.zeros(jb.n_rows, bool)
    has[:n] = np.diff(s.indptr) > 0
    np.testing.assert_array_equal(got[has], grid[has])
    # rows with no neighbour (isolated, padding, empty block-rows) get the
    # sentinel
    assert (got[~has] == np.float32(T.NEG_HUGE)).all() and (~has).any()


@pytest.mark.parametrize("bitmap", [False, True])
@pytest.mark.parametrize("bs", [32, 128])
def test_neighbor_max_signed_zero_ties_take_the_first(bitmap, bs):
    """A payload of +0.0, -0.0 and -1.0: of equal maxima a row keeps the
    first in column order (blocks in row_ptr order, columns ascending),
    bit for bit, the rule of the CUDA kernels; the values equal JAX's (the
    sign of JAX's zero is its reduction's)."""
    rng = np.random.default_rng(5)
    s = _structure(_banded(rng, n=640, bw=200))
    s.sort_indices()
    tb = T.BsrMatrix.from_scipy(s, bs, dtype="bits" if bitmap else np.int8,
                                device="cpu")
    x = rng.choice(np.array([0.0, -0.0, -1.0], np.float32), s.shape[1])
    got = T.bsr_neighbor_max(tb, torch.from_numpy(x)).numpy()
    want = np.full(tb.n_rows, np.float32(T.NEG_HUGE))
    for i in range(s.shape[0]):
        for j in s.indices[s.indptr[i]:s.indptr[i + 1]]:
            if x[j] > want[i]:
                want[i] = x[j]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    zero = got == 0
    assert np.signbit(got[zero]).any() and (~np.signbit(got[zero])).any()
    if bs == 128:
        jb = J.BsrMatrix.from_scipy(s, 128, dtype=np.int8)
        xj = jnp.asarray(np.concatenate(
            [x, np.full(jb.n_cols - x.size, J._NEG_HUGE, np.float32)]))
        rows = np.asarray(J._bsr_nbr_max_rows(
            jb.blk_vals, J.bsr_row_ptr(jb), jb.blk_cols, xj, jb.n_rows, 128,
            interpret=True))
        np.testing.assert_array_equal(got, rows)


@pytest.mark.parametrize("bitmap", [False, True])
def test_plain_versions_never_read_blocks_past_row_ptr(bitmap):
    """A sharded panel pads its block arrays past row_ptr[-1]: all-ones
    padding blocks change neither plain version's result."""
    rng = np.random.default_rng(6)
    s = _structure(_banded(rng, n=512))
    tb = T.BsrMatrix.from_scipy(s, 128, dtype="bits" if bitmap else np.int8,
                                device="cpu")
    rp = T.bsr_row_ptr(tb)
    pad = torch.full((3,) + tuple(tb.blk_vals.shape[1:]), -1,
                     dtype=tb.blk_vals.dtype)
    vals = torch.cat([tb.blk_vals, pad])
    cols = torch.cat([tb.blk_cols, tb.blk_cols.new_zeros(3)])
    x = torch.from_numpy(rng.standard_normal(512).astype(np.float32)) + 10
    xi = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, 512).astype(np.int32))
    for payload in (x, xi):
        np.testing.assert_array_equal(
            T.nbr_max_rows(vals, rp, cols, payload, 512, 128, bitmap),
            T.bsr_nbr_max_plain(tb.blk_vals, rp, tb.blk_cols, payload, 512,
                                128, bitmap))
    x2 = torch.from_numpy(rng.random((512, 8)).astype(np.float32))
    np.testing.assert_array_equal(
        T.spmm_rows(vals, rp, cols, x2, 512, 128, bitmap),
        T.bsr_spmm_plain(tb.blk_vals, rp, tb.blk_cols, x2, 512, 128, bitmap))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "bits"])
def test_spmm_matches_jax_and_scipy(case, kind):
    rng = np.random.default_rng(4)
    s = _banded(rng, **CASES[case])
    if kind in ("int8", "bits"):
        s = _structure(s)
    dtype = {"f32": np.float32, "bf16": torch.bfloat16, "int8": np.int8,
             "bits": "bits"}[kind]
    tb = T.BsrMatrix.from_scipy(s, 128, dtype=dtype, device="cpu")
    x = rng.random((s.shape[1], 24)).astype(np.float32)
    xt = torch.from_numpy(x)
    y_rows = T.bsr_spmm_rows(tb, xt).numpy()
    y_grid = T.bsr_spmm(tb, xt).numpy()
    assert y_rows.shape == (tb.n_rows, 24) and y_rows.dtype == np.float32
    np.testing.assert_array_equal(y_rows, y_grid)
    ref_s = s
    if kind == "bf16":     # the blocks hold bf16-rounded values
        vals = torch.from_numpy(s.data).to(torch.bfloat16).float().numpy()
        ref_s = sp.csr_matrix((vals, s.indices, s.indptr), shape=s.shape)
    ref = ref_s @ x
    np.testing.assert_allclose(y_rows[: s.shape[0]], ref, rtol=2e-5,
                               atol=1e-5)
    assert not y_rows[s.shape[0]:].any()
    if "empty" in case:
        assert not y_rows[128:256].any()
    if kind in ("f32", "int8"):
        jb = J.BsrMatrix.from_scipy(s, 128, dtype=dtype)
        xp = np.zeros((jb.n_cols, 128), np.float32)
        xp[: s.shape[1], :24] = x
        jr = np.asarray(J.bsr_spmm_rows(jb, jnp.asarray(xp),
                                        interpret=True))[:, :24]
        np.testing.assert_allclose(y_rows, jr, rtol=2e-5, atol=1e-5)
        jg = np.asarray(J.bsr_spmm_pallas(jb, jnp.asarray(xp),
                                          interpret=True))[:, :24]
        has = np.repeat(np.bincount(np.asarray(jb.blk_rows)[: jb.nb_real],
                                    minlength=jb.n_rows // 128) > 0, 128)
        np.testing.assert_allclose(y_grid[has], jg[has], rtol=2e-5,
                                   atol=1e-5)


def _edge_pair(s, bs, dtype):
    """(host-built, torch-built) edge forms of `s` at block size `bs`, and
    the value-kind matrix the torch builder read."""
    ind = T.BsrMatrix.from_scipy(_structure(s), bs, dtype="bits",
                                 device="cpu")
    tb = T.BsrMatrix.from_scipy(s, bs, dtype=dtype, device="cpu")
    host = T.edge_values_coo(s, ind, dtype=dtype)
    return host, T.edge_values(tb.blk_vals, T.bsr_row_ptr(tb)), tb


def _assert_edge_equal(a, b):
    np.testing.assert_array_equal(a.words.numpy(), b.words.numpy())
    np.testing.assert_array_equal(a.off.numpy(), b.off.numpy())
    assert (a.vals is None) == (b.vals is None)
    if a.vals is not None:
        assert a.vals.dtype == b.vals.dtype
        np.testing.assert_array_equal(a.vals.float().numpy(),
                                      b.vals.float().numpy())


def _unpack_edge(ev, row_ptr, blk_cols, bs, shape):
    """Dense S from the edge form, in numpy: the i-th set bit of run
    (block k, word-row g), in column then bit order, holds value
    off[k * nw + g] + i."""
    nw = bs // 32
    rp = row_ptr.numpy()
    words = ev.words.numpy()[: rp[-1]].view(np.uint32)
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    k, g, c, b = np.nonzero(bits)               # (block, g, column, bit)
    run = k * nw + g
    start = np.searchsorted(run, run)           # run's first set bit
    off = ev.off.numpy()
    at = off[run] + np.arange(run.size) - start
    vals = (np.ones(run.size, np.float32) if ev.vals is None
            else ev.vals.float().numpy()[at])
    brow = np.repeat(np.arange(rp.size - 1), np.diff(rp))
    dense = np.zeros(shape, np.float32)
    dense[brow[k] * bs + 32 * g + b, blk_cols.numpy()[k] * bs + c] = vals
    assert (np.diff(off) >= 0).all() and off[-1] == run.size
    return dense


@pytest.mark.parametrize("bs", [64, 128, 512])
@pytest.mark.parametrize("dtype", [np.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_builders_give_equal_arrays(case, dtype, bs):
    """The host builder (COO on a bitmap matrix's blocks) and the torch
    builder (value blocks and row_ptr) give equal words, values and run
    offsets; the words are the bitmap blocks; padding blocks past
    row_ptr[-1] give zero words and empty runs."""
    rng = np.random.default_rng(8)
    s = _banded(rng, **CASES[case])
    host, tor, tb = _edge_pair(s, bs, dtype)
    _assert_edge_equal(host, tor)
    _assert_edge_equal(tor, tb.edge)             # from_scipy built it once
    assert tor.vals.dtype == (torch.bfloat16 if dtype is torch.bfloat16
                              else torch.float32)
    assert tor.vals.numel() == s.nnz == int(tor.off[-1])
    rp = T.bsr_row_ptr(tb)
    if "empty" in case:                          # runs of an empty block-row
        k0, k1 = int(rp[128 // bs]), int(rp[256 // bs])
        assert int(tor.off[k0 * bs // 32]) == int(tor.off[k1 * bs // 32])
    # padding blocks of nonzero cells past row_ptr[-1]
    pad = torch.full((3, bs, bs), -1.0, dtype=tb.blk_vals.dtype)
    padded = T.edge_values(torch.cat([tb.blk_vals, pad]), rp)
    np.testing.assert_array_equal(padded.words.numpy()[: tb.num_blocks],
                                  host.words.numpy())
    assert not padded.words[tb.num_blocks:].any()
    np.testing.assert_array_equal(padded.vals.float().numpy(),
                                  host.vals.float().numpy())
    off = padded.off.numpy()
    np.testing.assert_array_equal(off[: host.off.numel()], host.off.numpy())
    assert (off[host.off.numel():] == off[host.off.numel() - 1]).all()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_form_unpacks_to_the_scipy_matrix(case, kind):
    rng = np.random.default_rng(9)
    s = _banded(rng, **CASES[case])
    if kind == "int8":
        s = _structure(s)
    dtype = {"f32": np.float32, "bf16": torch.bfloat16,
             "int8": np.int8}[kind]
    tb = T.BsrMatrix.from_scipy(s, 128, dtype=dtype, device="cpu")
    ev = tb.edge
    assert (ev.vals is None) == (kind == "int8")
    assert ev.words.dtype == torch.int32
    assert ev.words.shape == (tb.num_blocks, 4, 128)
    np.testing.assert_array_equal(
        ev.words.numpy(),
        T.pack_bits_blocks((tb.blk_vals != 0).numpy()))
    want = np.zeros((tb.n_rows, tb.n_cols), np.float32)
    ref = s.toarray()
    if kind == "bf16":
        ref = torch.from_numpy(ref).to(torch.bfloat16).float().numpy()
    want[: s.shape[0], : s.shape[1]] = ref
    got = _unpack_edge(ev, T.bsr_row_ptr(tb), tb.blk_cols, 128, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_spmm_plain_matches_jax(case):
    """`edge_spmm_plain` on both builders' edge forms against JAX's row-grid
    and block-grid SpMMs (interpret mode) on the value blocks, at
    `tests/test_spmm.py`'s rtol 2e-5 / atol 1e-5; the block grid's unset
    rows (block-rows with no block) are masked."""
    rng = np.random.default_rng(10)
    s = _banded(rng, **CASES[case])
    host, tor, tb = _edge_pair(s, 128, np.float32)
    jb = J.BsrMatrix.from_scipy(s, 128, dtype=np.float32)
    x = rng.random((jb.n_cols, 128)).astype(np.float32)
    xj = jnp.asarray(x)
    jr = np.asarray(J._bsr_spmm_rows(jb.blk_vals, J.bsr_row_ptr(jb),
                                     jb.blk_cols, xj, jb.n_rows, 128,
                                     interpret=True))
    jg = np.asarray(J._bsr_spmm(jb.blk_vals, jb.blk_rows, jb.blk_cols, xj,
                                jb.n_rows, 128, interpret=True))
    has = np.repeat(np.bincount(np.asarray(jb.blk_rows)[: jb.nb_real],
                                minlength=jb.n_rows // 128) > 0, 128)
    rp = T.bsr_row_ptr(tb)
    for ev in (host, tor):
        y = T.edge_spmm_plain(ev.words, rp, tb.blk_cols, ev.vals, ev.off,
                              torch.from_numpy(x), tb.n_rows, 128).numpy()
        assert y.shape == (jb.n_rows, 128) and y.dtype == np.float32
        np.testing.assert_allclose(y, jr, rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(y[has], jg[has], rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(y[: s.shape[0]], s @ x[: s.shape[1]],
                                   rtol=2e-5, atol=1e-5)


def test_sparse_support_takes_ell_route_on_cpu(rng):
    s = _banded(rng, n=300)
    x = rng.random((300, 16)).astype(np.float32)
    sup = T.SparseSupport(s, device="cpu")
    assert not sup.use_bsr
    y = (sup @ torch.from_numpy(x)).numpy()
    jy = np.asarray(J.SparseSupport(s) @ jnp.asarray(x))
    np.testing.assert_allclose(y, jy, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(y, s @ x, rtol=2e-5, atol=1e-5)


def test_kernel_wrappers_reject_bad_inputs(rng):
    s = _structure(_banded(rng, n=256))
    tb = T.BsrMatrix.from_scipy(s, 128, dtype="bits", device="cpu")
    rp = T.bsr_row_ptr(tb)
    x1 = torch.zeros(256)
    x2 = torch.zeros((256, 8))
    # CPU tensors: the wrappers never fall back to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        bsr_nbr_max_kernel(tb.blk_vals, rp, tb.blk_cols, x1, 256, 128, True)
    with pytest.raises(ValueError, match="CUDA"):
        bsr_spmm_kernel(tb.blk_vals, rp, tb.blk_cols, x2, 256, 128, True)
    with pytest.raises(ValueError, match="shape"):
        bsr_nbr_max_kernel(tb.blk_vals, rp, tb.blk_cols, x1, 256, 128, False)
    with pytest.raises(ValueError, match="multiple of 32"):
        bsr_spmm_kernel(tb.blk_vals, rp, tb.blk_cols, x2, 256, 48, True)
    with pytest.raises(ValueError, match="int32"):
        bsr_spmm_kernel(tb.blk_vals, rp.long(), tb.blk_cols, x2, 256, 128,
                        True)
    with pytest.raises(ValueError, match="1-D f32"):
        bsr_nbr_max_kernel(tb.blk_vals, rp, tb.blk_cols, x2, 256, 128, True)
    with pytest.raises(ValueError, match="blocks must be"):
        bsr_nbr_max_kernel(torch.zeros((tb.num_blocks, 128, 128)), rp,
                           tb.blk_cols, x1, 256, 128, False)
