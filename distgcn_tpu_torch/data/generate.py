"""Dataset generation — ER / BA / Poisson-geometric weighted conflict graphs.

The port's own copy of `distgcn_tpu/data/generate.py`: the same files for
the same seed. The exact labeller (`label_instance(exact=True)`) runs the
port's own native branch and bound (`solvers/exact.py`).

Re-specifies `Data_Generation.py`: graph families (:46-95), the two MWIS
labeling heuristics (:98-146), greedy baseline (:149-153), and the saved .mat
contract (:187-219). Also generates the wireless network instances
(`gdict{adj_c, adj_i, xys}` + random_seed) consumed by the wireless drivers
(`wireless_rollout_test_flood.py:53-68`, `wireless_dqn_test.py:147-152`).

No networkx dependency on the hot path — generators are numpy-native.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.spatial import distance_matrix

from distgcn_tpu_torch.data.matio import save_mat
from distgcn_tpu_torch.solvers.greedy import greedy_search

DIST_TAGS = {"uniform": "uni", "normal_l1": "nl1", "normal_l2": "nl2"}


def sample_weights(n: int, dist: str = "uniform", max_wts: float = 1.0,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Weight distributions (Data_Generation.py:48-57)."""
    rng = rng or np.random.default_rng()
    dist = dist.lower()
    if dist == "uniform":
        return rng.uniform(0, max_wts, n)
    if dist == "normal_l1":
        return np.abs(rng.standard_normal(n))
    if dist == "normal_l2":
        return np.square(rng.standard_normal(n))
    raise ValueError(f"unknown weight distribution {dist}")


def er_graph(n: int, p: float, rng: Optional[np.random.Generator] = None
             ) -> sp.csr_matrix:
    """Erdos-Renyi G(n, p) adjacency (fast sparse sampling)."""
    rng = rng or np.random.default_rng()
    iu, ju = np.triu_indices(n, k=1)
    keep = rng.random(iu.size) < p
    iu, ju = iu[keep], ju[keep]
    data = np.ones(iu.size)
    a = sp.coo_matrix((data, (iu, ju)), shape=(n, n))
    return (a + a.T).tocsr()


def ba_graph(n: int, m: int, rng: Optional[np.random.Generator] = None
             ) -> sp.csr_matrix:
    """Barabasi-Albert preferential attachment with m edges per new node.

    (Data_Generation.py:83-95 uses networkx with m = round(n*p).)
    """
    rng = rng or np.random.default_rng()
    m = max(1, min(m, n - 1))
    edges = []
    # start from a star over the first m+1 nodes
    targets = list(range(m))
    repeated = []
    for v in range(m, n):
        chosen = set()
        while len(chosen) < m:
            if repeated and rng.random() < 0.5:
                cand = repeated[rng.integers(len(repeated))]
            else:
                cand = targets[rng.integers(len(targets))]
            chosen.add(int(cand))
        for u in chosen:
            edges.append((v, u))
            repeated.extend([v, u])
        targets.append(v)
    iu = np.array([e[0] for e in edges])
    ju = np.array([e[1] for e in edges])
    a = sp.coo_matrix((np.ones(iu.size), (iu, ju)), shape=(n, n))
    a = ((a + a.T) > 0).astype(float)
    a.setdiag(0)
    return a.tocsr()


def poisson_geometric_graph(area: float, density: float, radius: float,
                            rng: Optional[np.random.Generator] = None
                            ) -> Tuple[sp.csr_matrix, np.ndarray]:
    """2D Poisson point process; connect points within `radius`
    (Data_Generation.py:61-80). Returns (adjacency, xy positions)."""
    rng = rng or np.random.default_rng()
    n = rng.poisson(lam=area * density)
    side = np.sqrt(area)
    xys = rng.uniform(0, side, (max(n, 1), 2))
    d = distance_matrix(xys, xys)
    adj = (d <= radius).astype(float)
    np.fill_diagonal(adj, 0)
    return sp.csr_matrix(adj), xys


# -- MWIS labeling heuristics (Data_Generation.py:98-146) -------------------

def mwis_heuristic_min_degree_ratio(adj: sp.spmatrix, wts: np.ndarray
                                    ) -> Tuple[list, float]:
    """Iteratively pick argmin_u (sum of -w over u's neighbors)/(-w_u) on the
    remaining graph; remove u and its neighbors (Data_Generation.py:98-125)."""
    adj0 = sp.csr_matrix(adj).toarray()
    a = -np.asarray(wts, dtype=float)
    labels = -np.ones(adj0.shape[0])
    while np.any(labels == -1):
        rem = labels == -1
        sub = adj0[np.ix_(rem, rem)]
        with np.errstate(divide="ignore", invalid="ignore"):
            score = a[rem].dot(sub != 0) / a[rem]
        u = int(np.argmin(score))
        sub_labels = -np.ones(sub.shape[0])
        sub_labels[u] = 1
        nbrs = np.nonzero(sub[u, :])[0]
        sub_labels[nbrs] = 0
        labels[rem] = sub_labels
    sel = np.nonzero(labels > 0)[0]
    return sel.tolist(), float(np.asarray(wts)[sel].sum())


def mwis_heuristic_maximal_sweep(adj: sp.spmatrix, wts: np.ndarray,
                                 rng: Optional[np.random.Generator] = None
                                 ) -> Tuple[list, float]:
    """For each seed node, grow a maximal IS (greedy by random order from the
    seed); keep the best (Data_Generation.py:128-146)."""
    rng = rng or np.random.default_rng()
    adj = sp.csr_matrix(adj)
    w = np.asarray(wts, dtype=float)
    n = w.size
    best, best_val = [], 0.0
    for u in range(n):
        taken = np.zeros(n, dtype=bool)
        blocked = np.zeros(n, dtype=bool)
        taken[u] = True
        nbrs = adj.indices[adj.indptr[u]: adj.indptr[u + 1]]
        blocked[nbrs] = True
        order = rng.permutation(n)
        for v in order:
            if taken[v] or blocked[v]:
                continue
            taken[v] = True
            nbrs = adj.indices[adj.indptr[v]: adj.indptr[v + 1]]
            blocked[nbrs] = True
        val = float(w[taken].sum())
        if val > best_val:
            best_val = val
            best = np.nonzero(taken)[0].tolist()
    return best, best_val


def label_instance(adj: sp.spmatrix, wts: np.ndarray,
                   rng: Optional[np.random.Generator] = None,
                   exact: bool = False, exact_timeout: float = 60.0):
    """Best of the two labeling heuristics + greedy baseline
    (Data_Generation.py:202-213). exact=True labels with the true optimum
    via the native B&B instead — the role of the reference's powerset
    `mwis_bruteforce` (Data_Generation.py:159-178), usable far beyond
    its ~20-node limit."""
    if exact:
        from distgcn_tpu_torch.solvers.exact import mwis_exact
        solu, val, _ = mwis_exact(adj, wts, exact_timeout)
        _, v0 = greedy_search(adj, wts)
        return set(np.asarray(solu).tolist()), float(val), v0
    m2, v2 = mwis_heuristic_maximal_sweep(adj, wts, rng)
    m1, v1 = mwis_heuristic_min_degree_ratio(adj, wts)
    _, v0 = greedy_search(adj, wts)
    mwis, val = (m1, v1) if v1 > v2 else (m2, v2)
    return mwis, val, v0


def generate_graph_dataset(datapath: str, graph_type: str = "ER",
                           sizes=(100,), ps=(0.1,), n_per_config: int = 10,
                           dist: str = "uniform", seed: Optional[int] = None,
                           label: bool = True) -> int:
    """Generate labeled .mat instances (Data_Generation.py:187-219).

    Filenames: ``{type}_n{N}_p{p}_b{i}_{dist}.mat``.
    Returns the number of files written.
    """
    os.makedirs(datapath, exist_ok=True)
    rng = np.random.default_rng(seed)
    count = 0
    for n in sizes:
        for p in ps:
            for i in range(n_per_config):
                gt = graph_type.lower()
                if gt == "er":
                    adj = er_graph(n, p, rng)
                elif gt == "ba":
                    adj = ba_graph(n, int(np.round(n * p)), rng)
                elif gt == "ppp":
                    density = n * 0.01
                    r = (10 * np.sqrt(p)) / (np.sqrt(np.pi) - 2 * np.sqrt(p))
                    adj, _ = poisson_geometric_graph(100, density, r, rng)
                    n = adj.shape[0]
                else:
                    raise ValueError(f"unknown graph type {graph_type}")
                wts = sample_weights(adj.shape[0], dist, rng=rng)
                extra = {"N": n, "p": p}
                if label:
                    mwis, val, v0 = label_instance(adj, wts, rng)
                    lab = np.zeros(adj.shape[0])
                    lab[mwis] = 1
                    extra.update(mwis_label=lab.reshape(1, -1),
                                 mwis_utility=val, greedy_utility=v0)
                fname = "{}_n{}_p{}_b{}_{}.mat".format(
                    graph_type, n, p, i, DIST_TAGS[dist.lower()])
                save_mat(os.path.join(datapath, fname), adj, wts, **extra)
                count += 1
    return count


def generate_wireless_network(datapath: str, n_networks: int = 10,
                              area: float = 250.0, n_nodes: int = 100,
                              r_connect: float = 1.0, r_interfere: float = 4.0,
                              seed: Optional[int] = None) -> int:
    """Generate wireless network .mat files for the scheduling simulators.

    Contract (`wireless_rollout_test_flood.py:53-68` + driver sim constants
    :148-152): ``gdict`` struct with connectivity adjacency over nodes
    (adj_c, within r_connect), interference/conflict adjacency over *links*
    (adj_i, links conflict when endpoints within r_interfere or sharing a
    node), and node positions xys; plus scalar random_seed.
    """
    os.makedirs(datapath, exist_ok=True)
    rng = np.random.default_rng(seed)
    written = 0
    for k in range(n_networks):
        net_seed = int(rng.integers(0, 2**31 - 1))
        r = np.random.default_rng(net_seed)
        side = np.sqrt(area)
        density = n_nodes / area
        n = max(2, r.poisson(lam=area * density))
        xys = r.uniform(0, side, (n, 2))
        d = distance_matrix(xys, xys)
        adj_c = (d <= r_connect).astype(float)
        np.fill_diagonal(adj_c, 0)
        # links = edges of the connectivity graph
        iu, ju = np.nonzero(np.triu(adj_c, k=1))
        nl = iu.size
        if nl == 0:
            continue
        # link conflict: shared endpoint, or any endpoint pair within r_interfere
        mid = 0.5 * (xys[iu] + xys[ju])
        dl = distance_matrix(mid, mid)
        adj_i = (dl <= r_interfere).astype(float)
        share = ((iu[:, None] == iu[None, :]) | (iu[:, None] == ju[None, :]) |
                 (ju[:, None] == iu[None, :]) | (ju[:, None] == ju[None, :]))
        adj_i = np.maximum(adj_i, share.astype(float))
        np.fill_diagonal(adj_i, 0)
        import scipy.io as sio
        sio.savemat(os.path.join(datapath, f"poisson_net_{k:04d}.mat"),
                    {"gdict": {"adj_c": adj_c, "adj_i": adj_i, "xys": xys},
                     "random_seed": net_seed})
        written += 1
    return written
