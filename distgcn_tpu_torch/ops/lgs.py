"""Batched Local Greedy Search (LGS) — the distributed MWIS solver.

Port of `distgcn_tpu/ops/lgs.py`. The reference's `local_greedy_search`
(heuristics.py:77-116) runs synchronized rounds: with the remaining-node set
frozen, node v enters the independent set iff its key ``(w_v, -v)`` strictly
exceeds every remaining neighbour's key; winners' remaining neighbours are
removed; repeat. Nodes are ranked once per solve by that total order
(`lgs_ranks`), so each round is one masked neighbour-max over integer ranks
plus a winner-neighbour exclusion, with no tie logic.

`batched_lgs` launches the hand-written CUDA kernel (`ops/lgs_cuda.py`) for
CUDA tensors and runs `batched_lgs_plain` for CPU tensors. The JAX
package's 3-round unroll is an XLA detail: rounds and selections do not
depend on it. `batched_lgs_multi` solves D weight variants of each graph on
one shared adjacency (the kernel's ``share`` mode on a card).
`lgs_round_counts` adds the reference's communication counters. `ell_lgs`
runs the same rounds on one large graph in neighbour-list form (the large
path's gather route, `large.py`).

State labels: -1 remaining, 0 excluded (or padding), 1 selected.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def lgs_order(wts: torch.Tensor) -> torch.Tensor:
    """The nodes by descending weight, ties to the smaller id (a stable
    argsort of -w along the last axis): `lgs_ranks` numbers them N..1."""
    return torch.argsort(-wts, dim=-1, stable=True)


def lgs_ranks(wts: torch.Tensor) -> torch.Tensor:
    """Total-order priority rank per node: rank[v] > rank[u] iff
    (w_v, -v) > (w_u, -u) lexicographically. [B, N] int32 in [1, N]."""
    n = wts.shape[-1]
    # the JAX package's second argsort is the inverse permutation, written
    # here as a scatter: inv[order[i]] = i
    order = lgs_order(wts)
    pos = torch.arange(n, device=wts.device).expand_as(order)
    inv = torch.empty_like(order).scatter_(-1, order, pos)
    return (n - inv).to(torch.int32)


def _round(adjb: torch.Tensor, ranks: torch.Tensor, sel: torch.Tensor
           ) -> torch.Tensor:
    """One synchronized LGS round: adjb [B,N,N] bool, ranks [B,N] int32,
    sel [B,N] int8 -> updated sel."""
    remain = sel == -1
    minus1 = torch.full_like(ranks, -1)
    rr = torch.where(remain, ranks, minus1)
    # max priority among remaining neighbours; -1 where none remain, so a
    # neighbourless remaining node (rank >= 1) always wins
    nbr_r = torch.where(adjb, rr[:, None, :], -1)
    m = nbr_r.amax(dim=-1)
    win = remain & (ranks > m)
    excl = remain & ~win & (adjb & win[:, None, :]).any(dim=-1)
    sel = torch.where(win, torch.ones_like(sel), sel)
    return torch.where(excl, torch.zeros_like(sel), sel)


def batched_lgs_plain(adj: torch.Tensor, wts: torch.Tensor,
                      mask: torch.Tensor, max_rounds: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch LGS: the reference the kernel is held against.

    Same contract as `batched_lgs`. Synchronises with the host once per
    round (the loop condition).
    """
    b, n = wts.shape
    adjb = adj > 0
    ranks = lgs_ranks(wts)
    sel = torch.where(mask, -1, 0).to(torch.int8)
    cap = n if max_rounds is None else int(max_rounds)
    r = 0
    while r < cap and bool((sel == -1).any()):
        sel = _round(adjb, ranks, sel)
        r += 1
    util = torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(dim=-1)
    return sel, util, torch.tensor(r, dtype=torch.int32, device=wts.device)


def batched_lgs(adj: torch.Tensor, wts: torch.Tensor, mask: torch.Tensor,
                max_rounds: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run LGS to completion on a batch of padded graphs.

    Args:
      adj:  [B, N, N] 0/1 adjacency (zero diagonal/padding); the kernel
        takes int8 or bool, the plain version any dtype.
      wts:  [B, N] node weights (can be negative; padding ignored via mask).
      mask: [B, N] bool, True for real nodes.
      max_rounds: optional round cap (`local_greedy_search_nstep`
        semantics). None = run until no node remains.

    Returns:
      sel    [B, N] int8 in {-1, 0, 1} (padding nodes -> 0)
      util   [B] total selected weight
      rounds [] int32 rounds executed (max over the batch)

    A CUDA call launches the kernel and does not synchronise with the host.
    """
    if wts.device.type == "cpu":
        return batched_lgs_plain(adj, wts, mask, max_rounds)
    from distgcn_tpu_torch.ops.lgs_cuda import batched_lgs_kernel
    sel, util, rounds = batched_lgs_kernel(adj, wts, mask, max_rounds)
    return sel, util, rounds.amax()


# Centralized greedy == LGS under the (w, -id) tie-break (the JAX package's
# ops/lgs.py module docstring gives the argument).
batched_greedy = batched_lgs


def _multi_mask(mask: torch.Tensor, q: int, d: int, n: int) -> torch.Tensor:
    if mask.shape == (q, n):
        return mask[:, None, :].expand(q, d, n)
    if mask.shape != (q, d, n):
        raise ValueError(f"mask must be [Q, N] or [Q, D, N] = "
                         f"{(q, n)} or {(q, d, n)}, got {tuple(mask.shape)}")
    return mask


def batched_lgs_multi_plain(adj: torch.Tensor, wts: torch.Tensor,
                            mask: torch.Tensor,
                            max_rounds: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch `batched_lgs_multi`: the rounds of the JAX package's
    `batched_lgs_multi`, with the adjacency broadcast over the D variants
    in each round's select + reduce. Synchronises with the host once per
    round (the loop condition)."""
    q, d, n = wts.shape
    mask = _multi_mask(mask, q, d, n)
    adjb = (adj > 0)[:, None, :, :]                       # [Q, 1, N, N]
    ranks = lgs_ranks(wts.reshape(q * d, n)).reshape(q, d, n)
    sel = torch.where(mask, -1, 0).to(torch.int8)
    cap = n if max_rounds is None else int(max_rounds)
    r = 0
    while r < cap and bool((sel == -1).any()):
        remain = sel == -1
        rr = torch.where(remain, ranks, torch.full_like(ranks, -1))
        m = torch.where(adjb, rr[:, :, None, :], -1).amax(dim=-1)
        win = remain & (ranks > m)
        excl = remain & ~win & (adjb & win[:, :, None, :]).any(dim=-1)
        sel = torch.where(win, torch.ones_like(sel), sel)
        sel = torch.where(excl, torch.zeros_like(sel), sel)
        r += 1
    util = torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(dim=-1)
    return sel, util, torch.tensor(r, dtype=torch.int32, device=wts.device)


def batched_lgs_multi(adj: torch.Tensor, wts: torch.Tensor,
                      mask: torch.Tensor, max_rounds: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LGS on D weight variants of each graph, sharing one adjacency.

    Args:
      adj:  [Q, N, N] 0/1 adjacency (the kernel takes int8 or bool).
      wts:  [Q, D, N] weight variants.
      mask: [Q, N] bool (every variant of a graph on the same nodes) or
        [Q, D, N] bool (a node set per variant).
      max_rounds: optional round cap.

    Returns (sel [Q, D, N] int8, util [Q, D], rounds [] int32, the max over
    all Q * D solves). A CUDA call is one kernel launch with
    ``share = D`` (weight row q * D + d reads adjacency q): the adjacency
    is never repeated D times. It does not synchronise with the host.
    """
    if wts.device.type == "cpu":
        return batched_lgs_multi_plain(adj, wts, mask, max_rounds)
    from distgcn_tpu_torch.ops.lgs_cuda import batched_lgs_kernel
    q, d, n = wts.shape
    rows = _multi_mask(mask, q, d, n).reshape(q * d, n).contiguous()
    sel, util, rounds = batched_lgs_kernel(adj, wts.reshape(q * d, n), rows,
                                           max_rounds, share=d)
    return sel.view(q, d, n), util.view(q, d), rounds.amax()


def lgs_round_counts(adj: torch.Tensor, wts: torch.Tensor,
                     mask: torch.Tensor):
    """LGS with the reference's communication-cost counters
    (heuristics.py:163-209): per-graph rounds, point-to-point messages (the
    remaining-degree sum per round) and broadcasts (|remain| per round plus
    one mute signal per selected node). Plain tensor code on either device.

    Returns (sel [B, N] int8, util [B], rounds [] int32, p2p [B] int32,
    bst [B] int32). Synchronises with the host once per round.
    """
    b, n = wts.shape
    adjb = adj > 0
    ranks = lgs_ranks(wts)
    sel = torch.where(mask, -1, 0).to(torch.int8)
    p2p = torch.zeros((b,), dtype=torch.int32, device=wts.device)
    bst = torch.zeros_like(p2p)
    r = 0
    while r < n and bool((sel == -1).any()):
        remain = sel == -1
        deg = (adjb & remain[:, None, :] & remain[:, :, None]).sum(dim=-1)
        p2p += (deg * remain).sum(dim=-1).to(torch.int32)
        bst += remain.sum(dim=-1).to(torch.int32)
        sel = _round(adjb, ranks, sel)
        r += 1
    bst += (sel == 1).sum(dim=-1).to(torch.int32)
    util = torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(dim=-1)
    return (sel, util, torch.tensor(r, dtype=torch.int32, device=wts.device),
            p2p, bst)


def ell_lgs(cols: torch.Tensor, valid: torch.Tensor, wts: torch.Tensor,
            mask: torch.Tensor, max_rounds: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LGS over one large graph in ELLPACK neighbour-list form: the plain
    gather formulation, O(N*K) per round.

      cols  [N, K] int neighbour ids (self-padded rows allowed)
      valid [N, K] bool, True for real edges
      wts   [N] weights, mask [N] bool real-node mask

    Same rounds as `batched_lgs`; returns (sel [N] int8, util, rounds).
    Synchronises with the host once per round (the loop condition).
    """
    n = wts.shape[-1]
    ranks = lgs_ranks(wts)
    cols = cols.long()
    sel = torch.where(mask, -1, 0).to(torch.int8)
    cap = n if max_rounds is None else int(max_rounds)
    r = 0
    while r < cap and bool((sel == -1).any()):
        remain = sel == -1
        rr = torch.where(remain, ranks, torch.full_like(ranks, -1))
        m = torch.where(valid, rr[cols], -1).amax(dim=-1)
        win = remain & (ranks > m)
        hit = (valid & win[cols]).any(dim=-1)
        excl = remain & ~win & hit
        sel = torch.where(win, torch.ones_like(sel), sel)
        sel = torch.where(excl, torch.zeros_like(sel), sel)
        r += 1
    util = torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(dim=-1)
    return sel, util, torch.tensor(r, dtype=torch.int32, device=wts.device)
