"""Port parity: GraphBatch and the dense support builders against JAX.

Both packages get the same numpy/scipy inputs; integer outputs must be
element-equal and float outputs allclose at 1e-6 (both run f32 math).
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
