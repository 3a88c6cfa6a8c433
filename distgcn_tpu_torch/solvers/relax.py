"""LP relaxations and message-passing rounding for MWIS.

The port's own copy of `distgcn_tpu/solvers/relax.py`. Re-specifies
heuristics.py:358-484 with scipy's HiGHS LP in place of GLPK/PuLP:

- `mwis_lp_edge_relax`   (:358-383): max w.x, x_u + x_v <= 1 per edge,
  0 <= x <= 1. Half-integral optimum.
- `mwis_lp_clique_relax` (:386-411): one constraint per maximal clique.
  The cliques come from `maximal_cliques`, the pivoting Bron-Kerbosch of
  networkx's ``find_cliques`` (which the reference calls) on the same
  sets, so the rows come in networkx's order without networkx.
- `mp_greedy`            (:414-449): clique-LP guided message-passing
  rounding: x in {0,1} fixed from LP integrality, then iterative local
  rounds — a node rounds to 1 if it beats all neighbors (weight, id tie),
  to 0 if a neighbor rounded to 1; deadlock broken by the max-weight
  undecided node.
- `mwis_lp_edge_dual`    (:452-484): dual edge prices (per-node covering).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog


def _edges(adj) -> Tuple[np.ndarray, np.ndarray]:
    a = sp.csr_matrix(adj)
    iu, ju = sp.triu(a, k=1).nonzero()
    return iu, ju


def mwis_lp_edge_relax(adj, wts) -> np.ndarray:
    """Fractional solution of the edge-relaxation LP (heuristics.py:358-383)."""
    w = np.asarray(wts, dtype=float).flatten()
    n = w.size
    iu, ju = _edges(adj)
    if iu.size:
        rows = np.repeat(np.arange(iu.size), 2)
        cols = np.stack([iu, ju], 1).flatten()
        a_ub = sp.csr_matrix((np.ones(2 * iu.size), (rows, cols)),
                             shape=(iu.size, n))
        res = linprog(-w, A_ub=a_ub, b_ub=np.ones(iu.size),
                      bounds=[(0, 1)] * n, method="highs")
    else:
        res = linprog(-w, bounds=[(0, 1)] * n, method="highs")
    return res.x


def maximal_cliques(adj):
    """Every maximal clique, as lists of node ids, in the order of
    ``networkx.find_cliques(networkx.from_scipy_sparse_array(adj))``
    (heuristics.py:387-388): the same pivot rule over the same sets, each
    neighbour set built in ascending id order as networkx builds it."""
    a = sp.csr_matrix(adj)
    n = a.shape[0]
    if n == 0:
        return []
    nbrs = [sorted(set(a.indices[a.indptr[u]: a.indptr[u + 1]].tolist()))
            for u in range(n)]
    adj_sets = {u: {v for v in nbrs[u] if v != u} for u in range(n)}
    out = []
    cand = set(range(n))
    subg = cand.copy()
    stack = []
    q_path = [None]
    u = max(subg, key=lambda u: len(cand & adj_sets[u]))
    ext_u = cand - adj_sets[u]
    while True:
        if ext_u:
            q = ext_u.pop()
            cand.remove(q)
            q_path[-1] = q
            adj_q = adj_sets[q]
            subg_q = subg & adj_q
            if not subg_q:
                out.append(q_path[:])
            else:
                cand_q = cand & adj_q
                if cand_q:
                    stack.append((subg, cand, ext_u))
                    q_path.append(None)
                    subg, cand = subg_q, cand_q
                    u = max(subg, key=lambda u: len(cand & adj_sets[u]))
                    ext_u = cand - adj_sets[u]
        else:
            q_path.pop()
            if not stack:
                return out
            subg, cand, ext_u = stack.pop()


def mwis_lp_clique_relax(adj, wts) -> np.ndarray:
    """Fractional solution of the clique-relaxation LP
    (heuristics.py:386-411)."""
    w = np.asarray(wts, dtype=float).flatten()
    n = w.size
    cliques = maximal_cliques(adj)
    rows, cols = [], []
    for i, c in enumerate(cliques):
        rows.extend([i] * len(c))
        cols.extend(c)
    a_ub = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                         shape=(len(cliques), n))
    res = linprog(-w, A_ub=a_ub, b_ub=np.ones(len(cliques)),
                  bounds=[(0, 1)] * n, method="highs")
    return res.x


def mp_greedy(adj, wts) -> Tuple[set, float]:
    """Clique-LP + message-passing rounding (heuristics.py:414-449)."""
    a = sp.csr_matrix(adj)
    w = np.asarray(wts, dtype=float).flatten()
    n = w.size
    relax = mwis_lp_clique_relax(a, w)
    x = np.full(n, np.nan)
    x[np.isclose(relax, 0.0)] = 0
    x[np.isclose(relax, 1.0)] = 1
    for _ in range(n):
        undecided = np.nonzero(np.isnan(x))[0]
        if undecided.size == 0:
            break
        x_prev = x.copy()
        for v in undecided:
            nbrs = a.indices[a.indptr[v]: a.indptr[v + 1]]
            if nbrs.size == 0:
                x[v] = 1
                continue
            vn = x_prev[nbrs]
            if np.nansum(vn == 1.0) > 0:
                x[v] = 0
            elif w[v] > w[nbrs].max():
                x[v] = 1
            elif w[v] == w[nbrs].max():
                if v < nbrs[np.argmax(w[nbrs])]:
                    x[v] = 1
            elif (vn == 0.0).sum() == nbrs.size:
                x[v] = 1
        still = np.nonzero(np.isnan(x))[0]
        if still.size == undecided.size:  # deadlock: force max-weight node
            v = still[np.argmax(w[still])]
            x[v] = 1
    solu = np.nonzero(x == 1.0)[0]
    # safety: enforce independence (rounding can conflict on odd structures)
    sel = set()
    blocked = set()
    for v in solu[np.argsort(-w[solu], kind="stable")]:
        if v in blocked:
            continue
        sel.add(int(v))
        blocked.update(a.indices[a.indptr[v]: a.indptr[v + 1]].tolist())
    return sel, float(w[list(sel)].sum()) if sel else 0.0


def mwis_lp_edge_dual(adj, wts) -> sp.csr_matrix:
    """Dual edge prices y_uv >= 0 with sum over v's edges >= w_v
    (heuristics.py:452-484). Returns them in the adjacency's sparsity."""
    a = sp.csr_matrix(adj)
    w = np.asarray(wts, dtype=float).flatten()
    n = w.size
    x0, x1 = a.nonzero()  # directed copies, as the reference
    ne = x0.size
    rows, cols = [], []
    for e in range(ne):
        rows.append(x0[e])
        cols.append(e)
    a_ub = sp.csr_matrix((-np.ones(ne), (rows, cols)), shape=(n, ne))
    res = linprog(np.ones(ne), A_ub=a_ub, b_ub=-w,
                  bounds=[(0, None)] * ne, method="highs")
    out = a.astype(float).copy()
    out[x0, x1] = res.x
    return out
