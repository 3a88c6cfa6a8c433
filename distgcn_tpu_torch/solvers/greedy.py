"""Host (numpy/scipy) MWIS heuristics — parity re-derivations.

The port's own copy of `distgcn_tpu/solvers/greedy.py`.

These reproduce the observable behavior of the reference `heuristics.py`
solvers, re-implemented vectorized (the reference iterates python sets per
node; here each synchronized round is a few array ops). They serve as the
ground-truth oracles for the device kernels in `distgcn_tpu_torch.ops.lgs` and as
drop-in host solvers for small graphs.

Semantics captured (see heuristics.py):
- greedy_search      (:13-35):  sort by weight desc; take node if no selected
                     neighbor yet.
- dist_greedy_search (:38-74):  rounds; candidate if w_v >= max_nbr_w/alpha
                     with alpha = 1 + eps/3; then a sequential maximal-IS pass
                     over the candidate set in iteration order.
- local_greedy_search(:77-116): rounds; v joins iff it beats every *remaining*
                     neighbor by weight, ties broken by smaller node id
                     (:106-111 — v wins a tie iff v < smallest-id neighbor
                     among those achieving the max weight). Equivalent to the
                     lexicographic key (w_v, -v) strictly exceeding all
                     remaining neighbors' keys. Isolated remaining nodes join.
- *_count/_stats/_overhead (:119-263): round / message / broadcast counters.
- local_greedy_search_nstep (:266-305): at most n rounds; also returns the
                     excluded (neighbor-of-winner) set.
"""

from __future__ import annotations

from typing import Set, Tuple

import numpy as np
import scipy.sparse as sp


def _as_csr(adj) -> sp.csr_matrix:
    if sp.issparse(adj):
        return adj.tocsr()
    return sp.csr_matrix(np.asarray(adj))


def _as_wts(wts) -> np.ndarray:
    return np.asarray(wts, dtype=np.float64).flatten()


def greedy_search(adj, wts) -> Tuple[Set[int], float]:
    """Centralized greedy MWIS (heuristics.py:13-35).

    Iterates nodes in decreasing weight; a node enters the IS unless a
    neighbor was already selected. Note the reference also skips *blocked*
    nodes' neighbor-marking (a blocked node never extends nb_is), reproduced
    here exactly.

    DELIBERATE tie-order deviation: the reference uses a non-stable
    ``np.argsort(-wts)`` (heuristics.py:22), so equal weights are visited in
    an unspecified order; here the sort is stable, making ties resolve to
    the smaller node id. For the continuous weight distributions of every
    dataset/driver the two are identical (ties have measure zero); the
    stable order is load-bearing for the greedy == LGS set-equality that
    `ops.lgs.batched_greedy` exploits (see ops/lgs.py module docstring).
    """
    adj = _as_csr(adj)
    w = _as_wts(wts)
    order = np.argsort(-w, kind="stable")
    in_is = np.zeros(w.size, dtype=bool)
    blocked = np.zeros(w.size, dtype=bool)
    for v in order:
        if blocked[v]:
            continue
        in_is[v] = True
        nbrs = adj.indices[adj.indptr[v]: adj.indptr[v + 1]]
        blocked[nbrs] = True
    mwis = set(np.nonzero(in_is)[0].tolist())
    return mwis, float(w[in_is].sum())


def local_greedy_search(adj, wts) -> Tuple[Set[int], float]:
    """Distributed local greedy (LGS) — heuristics.py:77-116."""
    sel, _, _ = _lgs_rounds(adj, wts, max_rounds=None)
    w = _as_wts(wts)
    mwis = set(np.nonzero(sel == 1)[0].tolist())
    return mwis, float(w[sel == 1].sum())


def local_greedy_search_count(adj, wts):
    """LGS + number of rounds (heuristics.py:119-160)."""
    sel, rounds, _ = _lgs_rounds(adj, wts, max_rounds=None)
    w = _as_wts(wts)
    mwis = set(np.nonzero(sel == 1)[0].tolist())
    return mwis, float(w[sel == 1].sum()), rounds


def local_greedy_search_stats(adj, wts):
    """LGS + (rounds, point-to-point msgs, broadcasts) (heuristics.py:163-209).

    Cost model: each round every remaining node broadcasts once (bst +=
    |remain|) and receives one message per remaining neighbor (p2p += degree
    within remain); winners broadcast a final mute signal (bst += |mwis|).
    """
    sel, rounds, per_round = _lgs_rounds(adj, wts, max_rounds=None,
                                         want_stats=True)
    w = _as_wts(wts)
    mwis_mask = sel == 1
    p2p = int(sum(s["p2p"] for s in per_round))
    bst = int(sum(s["bst"] for s in per_round)) + int(mwis_mask.sum())
    mwis = set(np.nonzero(mwis_mask)[0].tolist())
    return mwis, float(w[mwis_mask].sum()), rounds, p2p, bst


def local_greedy_search_overhead(adj, wts):
    """LGS + per-node overhead vector (heuristics.py:212-263).

    overhead[v] = total remaining-neighbor messages received by v across
    rounds, +1 if v entered the IS (mute signaling).
    """
    sel, rounds, per_round = _lgs_rounds(adj, wts, max_rounds=None,
                                         want_stats=True)
    w = _as_wts(wts)
    oh_vec = np.zeros_like(w)
    for s in per_round:
        oh_vec += s["deg_in_remain"]
    mwis_mask = sel == 1
    oh_vec[mwis_mask] += 1
    p2p = int(sum(s["p2p"] for s in per_round))
    bst = int(sum(s["bst"] for s in per_round)) + int(mwis_mask.sum())
    mwis = set(np.nonzero(mwis_mask)[0].tolist())
    return mwis, float(w[mwis_mask].sum()), rounds, p2p, bst, oh_vec


def local_greedy_search_nstep(adj, wts, nstep: int = 1):
    """At most `nstep` LGS rounds; returns (mwis, util, excluded_set)
    (heuristics.py:266-305)."""
    sel, _, _ = _lgs_rounds(adj, wts, max_rounds=nstep)
    w = _as_wts(wts)
    mwis = set(np.nonzero(sel == 1)[0].tolist())
    nb_is = set(np.nonzero(sel == 0)[0].tolist())
    return mwis, float(w[sel == 1].sum()), nb_is


def dist_greedy_search(adj, wts, epsilon: float = 0.5) -> Tuple[Set[int], float]:
    """Threshold-based distributed greedy (heuristics.py:38-74).

    Round: node is a candidate if it has no remaining neighbors or
    w_v >= max(remaining nbr w)/alpha, alpha = 1 + eps/3. Candidates are then
    admitted sequentially in index order, skipping any whose neighbor was
    already admitted this round (a maximal-IS pass over candidates). Nodes
    adjacent to any admitted node (across rounds) are removed.

    Quirk preserved: the reference's nb_is accumulates neighbors of admitted
    nodes over *all* rounds and the remainder is ``remain - mwis - nb_is``,
    while the round-candidate test only intersects `remain`.
    """
    adj = _as_csr(adj)
    w = _as_wts(wts)
    n = w.size
    alpha = 1.0 + (epsilon / 3.0)
    remain = np.ones(n, dtype=bool)
    in_is = np.zeros(n, dtype=bool)
    blocked = np.zeros(n, dtype=bool)
    while remain.any():
        # candidate test against remaining neighbors
        cand = np.zeros(n, dtype=bool)
        rem_idx = np.nonzero(remain)[0]
        for v in rem_idx:
            nbrs = adj.indices[adj.indptr[v]: adj.indptr[v + 1]]
            nbrs = nbrs[remain[nbrs]]
            if nbrs.size == 0 or w[v] >= w[nbrs].max() / alpha:
                cand[v] = True
        # sequential maximal-IS pass over candidates (reference set-iteration
        # order == ascending index for python ints < 2**63 in CPython sets of
        # small ints; we use ascending index deterministically)
        round_sel = np.zeros(n, dtype=bool)
        for v in np.nonzero(cand)[0]:
            nbrs = adj.indices[adj.indptr[v]: adj.indptr[v + 1]]
            if not round_sel[nbrs].any():
                round_sel[v] = True
                blocked[nbrs] = True
        in_is |= round_sel
        remain &= ~(in_is | blocked)
    mwis = set(np.nonzero(in_is)[0].tolist())
    return mwis, float(w[in_is].sum())


# ---------------------------------------------------------------------------

def _lgs_rounds(adj, wts, max_rounds=None, want_stats=False):
    """Shared LGS round engine.

    Each round (with `remain` frozen): node v wins iff it has no remaining
    neighbor, or its key (w_v, -v) strictly exceeds every remaining
    neighbor's key. Winners' neighbors are excluded. Returns a label vector
    sel in {-1 remain, 0 excluded, 1 selected}, the round count, and optional
    per-round stats.
    """
    adj = _as_csr(adj)
    w = _as_wts(wts)
    n = w.size
    sel = -np.ones(n, dtype=np.int8)
    rounds = 0
    stats = []
    limit = np.inf if max_rounds is None else max_rounds
    while (sel == -1).any() and rounds < limit:
        remain = sel == -1
        rem_idx = np.nonzero(remain)[0]
        # adjacency restricted to remaining nodes (rows/cols in rem order)
        sub = adj[rem_idx][:, rem_idx].tocsr()
        wr = w[rem_idx]
        deg = np.diff(sub.indptr)
        nonempty = deg > 0
        # per-row segmented max of neighbor weights / min id among the tied
        # (reduceat is undefined on empty segments -> restrict to nonempty)
        nbr_max = np.full(rem_idx.size, -np.inf)
        tied_min = np.full(rem_idx.size, n, dtype=np.int64)
        if sub.nnz:
            nbr_w = wr[sub.indices]
            starts = sub.indptr[:-1][nonempty]
            nbr_max[nonempty] = np.maximum.reduceat(nbr_w, starts)
            row_of = np.repeat(np.arange(rem_idx.size), deg)
            nbr_ids = rem_idx[sub.indices].astype(np.int64)
            tied_ids = np.where(nbr_w == nbr_max[row_of], nbr_ids, n)
            tied_min[nonempty] = np.minimum.reduceat(tied_ids, starts)
        # spec rule (heuristics.py:106-111): win iff no remaining neighbor,
        # or w > all neighbor w, or tied at the max with the smallest id
        win = (~nonempty | (wr > nbr_max)
               | ((wr == nbr_max) & (rem_idx < tied_min)))
        winners = rem_idx[win]
        sel[winners] = 1
        # exclude remaining neighbors of winners (one SpMV on the full adj)
        if winners.size:
            win_vec = np.zeros(n)
            win_vec[winners] = 1.0
            hit = np.asarray(adj @ win_vec).flatten() > 0
            sel[hit & remain & (sel != 1)] = 0
        if want_stats:
            full_deg = np.zeros(n)
            full_deg[rem_idx] = deg
            stats.append({"p2p": int(deg.sum()), "bst": int(rem_idx.size),
                          "deg_in_remain": full_deg})
        rounds += 1
    return sel, rounds, stats
