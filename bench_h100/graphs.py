"""The benchmark's graph generators (the yardstick's own copies; the
program's generators may change, these may not).

- `er_batch`: seeded Erdos-Renyi conflict graphs of n_lo..n_hi links with
  edge probability mean_degree / n, padded to `pad_to`
  (`chip_smoke.graphs`, the repository's dense bench batch).
- `geometric`: links dropped uniformly in the unit square conflict when
  closer than the radius that gives the mean degree; nodes in serpentine
  tiles of 256 (`large.geometric_conflict_graph(order="grid")`).
- `weighted_copy`: each undirected conflict weighted uniformly in
  [lo, hi) (`scripts/torch_weighted_solve.py`'s interference weights).

Every generator takes a numpy Generator, which the drivers derive from
the run's seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree


def er_batch(rng: np.random.Generator, batch: int, n_lo: int, n_hi: int,
             pad_to: int, mean_degree: float
             ) -> Tuple[np.ndarray, np.ndarray, List[int], List[int]]:
    """(adj [batch, pad_to, pad_to] float32 0/1, mask [batch, pad_to] bool,
    real links per graph, directed edges per graph)."""
    adj = np.zeros((batch, pad_to, pad_to), np.float32)
    mask = np.zeros((batch, pad_to), bool)
    ns, es = [], []
    for b in range(batch):
        n = int(rng.integers(n_lo, n_hi + 1))
        a = np.triu(rng.random((n, n)) < min(1.0, mean_degree / n), 1)
        a = a | a.T
        adj[b, :n, :n] = a
        mask[b, :n] = True
        ns.append(n)
        es.append(int(a.sum()))
    return adj, mask, ns, es


def serpentine_order(xy: np.ndarray, tile: int = 256) -> np.ndarray:
    """Nodes cut into equal-count horizontal bands (by y rank), each band
    sorted by x in alternating direction: new index -> old index."""
    n = xy.shape[0]
    g = max(int(round(np.sqrt(max(n // tile, 1)))), 1)
    yrank = np.empty(n, np.int64)
    yrank[np.argsort(xy[:, 1], kind="stable")] = np.arange(n)
    band = np.minimum(yrank * g // n, g - 1)
    x = xy[:, 0].copy()
    flip = band % 2 == 1
    x[flip] = -x[flip]
    return np.lexsort((x, band))


def geometric(rng: np.random.Generator, n: int, avg_degree: float,
              order: str = "grid") -> sp.csr_matrix:
    """Symmetric 0/1 float32 csr adjacency of n links."""
    if order != "grid":
        raise ValueError(f"order {order!r}: the benchmark uses 'grid'")
    xy = rng.random((n, 2))
    radius = np.sqrt((avg_degree + 1) / (np.pi * n))
    pairs = cKDTree(xy).query_pairs(radius, output_type="ndarray")
    adj = sp.coo_matrix((np.ones(len(pairs), np.float32),
                         (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    adj = (adj + adj.T).tocsr()
    perm = serpentine_order(xy, tile=256)
    return adj[perm][:, perm].tocsr()


def weighted_copy(rng: np.random.Generator, adj: sp.csr_matrix, lo: float,
                  hi: float) -> sp.csr_matrix:
    """The same structure, each undirected edge uniform in [lo, hi)."""
    up = sp.triu(adj, 1).tocsr()
    up.data = (rng.random(up.nnz) * (hi - lo) + lo).astype(np.float32)
    return (up + up.T).tocsr()
