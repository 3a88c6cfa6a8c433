"""Wireless network graph utilities — re-spec of the missing `graph_util`.

The port's own copy of `distgcn_tpu/data/wireless.py` (host numpy/scipy
code, the same arrays for the same inputs).

The reference imports a `graph_util` module that is absent from its tree;
its definitions are recoverable from the inlined copies in
`wireless_rollout_test_flood.py:53-133`:

- poisson_graphs_from_dict(gdict): connectivity graph (adj_c, node positions
  xys) + conflict graph over links (adj_i).
- poisson_multigraphs_from_dict(gdict, k, p): k per-channel conflict graphs,
  each inter-link edge kept independently with probability p.
- multichannel_conflict_graph(graphs): per-channel adjacency list + the
  product conflict graph over (link, channel) pairs with single-radio
  cross-channel cliques per link (node j = k * n_links + i).
- pad_product_graph: the product graph re-blocked for a padded link count
  (the device loops' batches).

`connection_graph_poisson` / `multichannel_conflict_simulate` are the
renamed equivalents used by `wireless_dqn_test_mc.py:159-161`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp


def _unpack_gdict(gdict):
    """gdict is a scipy.io matlab struct (object array) or a plain dict."""
    def get(name):
        if isinstance(gdict, dict):
            return np.asarray(gdict[name])
        return np.asarray(gdict[name][0, 0] if gdict[name].dtype == object
                          else gdict[name])
    try:
        adj_c = get("adj_c")
        adj_i = get("adj_i")
        xys = get("xys")
    except Exception:
        # matlab struct field access
        adj_c = np.asarray(gdict["adj_c"])
        adj_i = np.asarray(gdict["adj_i"])
        xys = np.asarray(gdict["xys"])
    return np.asarray(adj_c, dtype=float), np.asarray(adj_i, dtype=float), xys


def poisson_graphs_from_dict(gdict) -> Tuple[sp.csr_matrix, np.ndarray,
                                             sp.csr_matrix]:
    """Returns (connectivity adj over nodes, xys, conflict adj over links).

    Reference: wireless_rollout_test_flood.py:53-68 (returns networkx graphs;
    we return the adjacency + positions directly).
    """
    adj_c, adj_i, xys = _unpack_gdict(gdict)
    np.fill_diagonal(adj_c, 0)
    adj_i = adj_i.copy()
    np.fill_diagonal(adj_i, 0)
    return sp.csr_matrix(adj_c), xys, sp.csr_matrix(adj_i)


# renamed equivalent (wireless_dqn_test_mc.py:159)
def connection_graph_poisson(adj_c, xys) -> Tuple[sp.csr_matrix, np.ndarray]:
    adj_c = np.asarray(adj_c, dtype=float).copy()
    np.fill_diagonal(adj_c, 0)
    return sp.csr_matrix(adj_c), np.asarray(xys)


def flows_from_connectivity(adj_c) -> List[Tuple[int, int]]:
    """Link list = edges of the connectivity graph, in (i<j) order —
    matches `[e for e in graph_c.edges]` (wireless_rollout_test_flood.py:211)."""
    a = sp.csr_matrix(adj_c)
    iu, ju = sp.triu(a, k=1).nonzero()
    return list(zip(iu.tolist(), ju.tolist()))


def poisson_multigraphs_from_dict(gdict, k: int = 3, p: float = 0.8,
                                  rng: Optional[np.random.Generator] = None
                                  ) -> Tuple[sp.csr_matrix, List[sp.csr_matrix]]:
    """k per-channel conflict graphs; each inter-link edge kept w.p. p
    (wireless_rollout_test_flood.py:71-95)."""
    adj_c, adj_i, _ = _unpack_gdict(gdict)
    np.fill_diagonal(adj_c, 0)
    graphs = multichannel_conflict_simulate(adj_i, k, p, rng)
    return sp.csr_matrix(adj_c), graphs


# renamed equivalent (wireless_dqn_test_mc.py:160)
def multichannel_conflict_simulate(adj_i, k: int = 3, p: float = 0.8,
                                   rng: Optional[np.random.Generator] = None
                                   ) -> List[sp.csr_matrix]:
    rng = rng or np.random.default_rng()
    adj_i = np.asarray(adj_i, dtype=float).copy()
    np.fill_diagonal(adj_i, 0)
    n = adj_i.shape[0]
    iu, ju = np.nonzero(np.triu(adj_i, k=1))
    graphs = []
    for _ in range(k):
        keep = rng.random(iu.size) <= p
        a = sp.coo_matrix((np.ones(keep.sum()), (iu[keep], ju[keep])),
                          shape=(n, n))
        graphs.append(((a + a.T) > 0).astype(float).tocsr())
    return graphs


def multichannel_conflict_graph(graphs: List[sp.spmatrix]
                                ) -> Tuple[List[sp.csr_matrix], sp.csr_matrix]:
    """Product conflict graph over (link, channel) with single-radio
    cross-channel cliques (wireless_rollout_test_flood.py:98-133).

    Node numbering: j = k * n_links + i for link i on channel k — matching
    the reference's order='F' weight reshape (wireless_dqn_test_mc.py:240).
    """
    nk = len(graphs)
    sizes = {g.shape[0] for g in graphs}
    assert len(sizes) == 1, "channel graphs must share the link set"
    nn = sizes.pop()
    adj_list = [sp.csr_matrix(g) for g in graphs]
    big = sp.lil_matrix((nk * nn, nk * nn))
    # per-channel conflict edges
    for k, g in enumerate(adj_list):
        iu, ju = sp.triu(g, k=1).nonzero()
        big[k * nn + iu, k * nn + ju] = 1
        big[k * nn + ju, k * nn + iu] = 1
    # single-radio constraint: same link across channels forms a clique
    for i in range(nn):
        for k1 in range(nk):
            for k2 in range(k1 + 1, nk):
                big[k1 * nn + i, k2 * nn + i] = 1
                big[k2 * nn + i, k1 * nn + i] = 1
    return adj_list, big.tocsr()


def pad_product_graph(adj_gk: sp.spmatrix, nflows: int, n_ch: int,
                      nflows_pad: int) -> np.ndarray:
    """Re-block a product conflict graph for a padded link count.

    The multichannel node numbering is j = ch * nflows + link
    (`multichannel_conflict_graph`); device batching pads the LINK dimension
    (nflows -> nflows_pad), which shifts every channel block. Returns a
    dense [n_ch * nflows_pad, n_ch * nflows_pad] adjacency with each
    channel-block copied to its padded offset (padding rows/cols zero).
    Used with `distgcn_tpu_torch.sim.device_sim.make_closed_loop_mc` and a
    [.., nflows_pad] link mask.
    """
    assert nflows_pad >= nflows
    a = sp.csr_matrix(adj_gk).toarray()
    nkp = n_ch * nflows_pad
    out = np.zeros((nkp, nkp), dtype=np.float32)
    for k1 in range(n_ch):
        for k2 in range(n_ch):
            blk = a[k1 * nflows:(k1 + 1) * nflows,
                    k2 * nflows:(k2 + 1) * nflows]
            out[k1 * nflows_pad:k1 * nflows_pad + nflows,
                k2 * nflows_pad:k2 * nflows_pad + nflows] = blk
    return out
