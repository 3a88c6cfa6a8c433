"""Port parity: GraphBatch, the dense support builders, and the host
(scipy/numpy) halves of `core/prep` and `core/graph` against JAX.

Both packages get the same numpy/scipy inputs; integer outputs must be
element-equal and float outputs allclose at 1e-6 (both run f32 math). The
host functions run float64 scipy: the structural ones (`block_diag_stack`,
`edges_from_dense`, `sparse_to_tuple`, `preprocess_features`) are exact,
the normalizations and powers within `tests/test_prep.py`'s tolerances,
and `chebyshev_polynomials` within its eigen-solver tolerance (1e-8).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conftest import random_graph
from distgcn_tpu.core import graph as jgraph
from distgcn_tpu.core import prep as jprep
from distgcn_tpu_torch.core import graph as tgraph
from distgcn_tpu_torch.core import prep as tprep

TOL = dict(rtol=1e-6, atol=1e-6)


def _graphs(rng, sizes, p=0.15):
    adjs = [random_graph(rng, n=n, p=p) for n in sizes]
    wts = [rng.random(n) - 0.2 for n in sizes]
    return adjs, wts


@pytest.mark.parametrize("sizes,pad_to", [
    ((20, 37, 50), 64),
    ((5, 128, 90), 0),       # pad_bucket picks 128
    ((1, 3), 8),             # tiny graphs, one without edges
])
def test_graph_batch_from_scipy_matches_jax(rng, sizes, pad_to):
    adjs, wts = _graphs(rng, sizes)
    # one dense input among the scipy ones (both constructors accept it)
    adjs[0] = adjs[0].toarray()
    jb = jgraph.GraphBatch.from_scipy(adjs, wts, pad_to=pad_to)
    tb = tgraph.GraphBatch.from_scipy(adjs, wts, pad_to=pad_to,
                                      device="cpu")
    assert tb.adj.dtype == torch.int8
    np.testing.assert_array_equal(tb.adj.numpy(), np.asarray(jb.adj))
    np.testing.assert_array_equal(tb.wts.numpy(), np.asarray(jb.wts))
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    np.testing.assert_array_equal(tb.nn.numpy(), np.asarray(jb.nn))
    assert (tb.batch_size, tb.pad_n) == (jb.batch_size, jb.pad_n)
    for a, b in zip(tb.to_scipy(), jb.to_scipy()):
        assert (a != b).nnz == 0


def test_graph_batch_rejects_small_pad(rng):
    adjs, wts = _graphs(rng, (40,))
    with pytest.raises(ValueError):
        tgraph.GraphBatch.from_scipy(adjs, wts, pad_to=32, device="cpu")


def test_pad_bucket_and_fingerprint_match_jax(rng):
    for n in (1, 127, 128, 129, 300):
        for bucket in (8, 128):
            assert tgraph.pad_bucket(n, bucket) == jgraph.pad_bucket(n, bucket)
    a = random_graph(rng, n=30, p=0.2)
    assert tgraph.graph_fingerprint(a) == jgraph.graph_fingerprint(a)
    assert (tgraph.graph_fingerprint(a.toarray())
            == jgraph.graph_fingerprint(sp.csr_matrix(a)))


@pytest.fixture
def batch_pair(rng):
    adjs, wts = _graphs(rng, (30, 45, 12), p=0.2)
    jb = jgraph.GraphBatch.from_scipy(adjs, wts, pad_to=48)
    tb = tgraph.GraphBatch.from_scipy(adjs, wts, pad_to=48, device="cpu")
    return jb, tb


def test_normalize_adj_dense_matches_jax(batch_pair):
    jb, tb = batch_pair
    np.testing.assert_allclose(tprep.normalize_adj_dense(tb.adj).numpy(),
                               np.asarray(jprep.normalize_adj_dense(jb.adj)),
                               **TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_simple_polynomials_dense_matches_jax(batch_pair, k):
    jb, tb = batch_pair
    got = tprep.simple_polynomials_dense(tb.adj, k)
    want = np.asarray(jprep.simple_polynomials_dense(jb.adj, k))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_masked_simple_polynomials_dense_matches_jax(batch_pair, k):
    jb, tb = batch_pair
    got = tprep.masked_simple_polynomials_dense(tb.adj, tb.mask, k)
    want = np.asarray(jprep.masked_simple_polynomials_dense(jb.adj, jb.mask,
                                                            k))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_preprocess_features_dense_matches_jax(rng):
    f = rng.random((3, 10, 4)).astype(np.float32)
    f[0, 2] = 0.0            # zero-sum row -> 0
    f[1, 5] = [1.0, -1.0, 0.5, -0.5]
    got = tprep.preprocess_features_dense(torch.from_numpy(f))
    want = np.asarray(jprep.preprocess_features_dense(f))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the host (scipy/numpy) half of core/prep and core/graph
# ---------------------------------------------------------------------------

HOST_SIZES = (1, 12, 40, 60)        # 1 node: no edge; 60: the default


def _host_graphs(rng):
    gs = [random_graph(rng, n=n, p=0.1) for n in HOST_SIZES]
    gs.append(sp.csr_matrix((7, 7)))                    # every node isolated
    return gs


def _same_sparse(a, b, atol):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=0, atol=atol)


@pytest.mark.parametrize("name,atol", [
    ("normalize_adj", 1e-12), ("preprocess_adj", 1e-12),
    ("laplacian_support", 1e-12)])
def test_host_normalizations_match_jax(rng, name, atol):
    """`tests/test_prep.py`'s tolerance for the normalizations."""
    for a in _host_graphs(rng):
        got = getattr(tprep, name)(a)
        want = getattr(jprep, name)(a)
        assert type(got) is type(want)
        _same_sparse(got, want, atol)


@pytest.mark.parametrize("name", ["simple_polynomials", "plain_polynomials"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_host_polynomials_match_jax(rng, name, k):
    """`tests/test_prep.py`'s tolerance for the powers (1e-10)."""
    for a in _host_graphs(rng):
        got = getattr(tprep, name)(a, k)
        want = getattr(jprep, name)(a, k)
        assert len(got) == len(want) == k + 1
        for g, w in zip(got, want):
            _same_sparse(g, w, 1e-10)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_host_chebyshev_polynomials_match_jax(rng, k):
    """ARPACK's largest eigenvalue starts from its own random vector in
    each call: the eigen-solver's tolerance, `tests/test_prep.py`'s 1e-8,
    and the recurrence T2 = 2 L^ T1 - T0 held on the port's own output."""
    for n, p in ((30, 0.15), (60, 0.08)):
        a = random_graph(rng, n=n, p=p)
        got = tprep.chebyshev_polynomials(a, k)
        want = jprep.chebyshev_polynomials(a, k)
        assert len(got) == len(want) == k + 1
        for g, w in zip(got, want):
            _same_sparse(g, w, 1e-8)
        if k >= 2:
            t1 = got[1].toarray()
            np.testing.assert_allclose(got[2].toarray(),
                                       2 * t1 @ t1 - np.eye(n), atol=1e-8)


def test_host_preprocess_features_matches_jax(rng):
    f = rng.random((50, 6))
    f[[3, 17, 40]] = 0.0                                 # zero-sum rows
    f[5, :3], f[5, 3:] = 1.0, -1.0                       # sums to 0 too
    got = tprep.preprocess_features(f)
    want = jprep.preprocess_features(f)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tprep.preprocess_features(
        [[1.0, 3.0], [0.0, 0.0], [2.0, 2.0]]),
        [[0.25, 0.75], [0, 0], [0.5, 0.5]], atol=1e-7)


def test_sparse_to_tuple_matches_jax(rng):
    for a in _host_graphs(rng) + [np.eye(3)]:
        got = tprep.sparse_to_tuple(a)
        want = jprep.sparse_to_tuple(a)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_block_diag_stack_matches_jax(rng):
    gs = _host_graphs(rng)
    gs[1] = gs[1].toarray()                              # dense input too
    got = tgraph.block_diag_stack(gs)
    want = jgraph.block_diag_stack(gs)
    assert got.format == want.format == "csr"
    assert got.shape == want.shape == (sum(HOST_SIZES) + 7,) * 2
    assert (got != want).nnz == 0


def test_edges_from_dense_matches_jax(rng):
    for a in _host_graphs(rng):
        got = tgraph.edges_from_dense(a.toarray())
        want = jgraph.edges_from_dense(a.toarray())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].size == a.nnz // 2
