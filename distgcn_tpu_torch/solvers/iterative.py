"""Iterative GCN-in-the-loop MWIS solvers: DIT, CGS and rollout.

Port of `distgcn_tpu/solvers/iterative.py`. The graph never changes shape:
removed nodes are masked out and the supports are rebuilt from the masked
adjacency each step (identical numerics to re-slicing the graph, since
masked rows and columns are zero and the normalisation is per row). Each
loop is a host ``while`` whose condition synchronises once per step.

- DIT (`solve_mwis_dit`, mwis_gdpg_call.py:278-318): the GCN re-scores the
  remaining nodes, one LGS round commits its winners; repeat. On a card the
  round is one launch of the LGS kernel on the remaining nodes
  (``max_rounds=1``; ranks are a total order, so only their order among
  the remaining nodes matters), merged into the state.
- CGS (`solve_mwis_cit`/`_wrap`, mwis_gdpg_call.py:320-384): the GCN
  re-scores, the single best node is committed per step.
- Rollout (`solve_mwis_rollout`/`_wrap`, mwis_gdpg_call.py:386-659): the
  top-b children by GCN weight; each is scored w_child + greedy(remainder
  without the child and its neighbours), the best child is committed. The
  b greedy evaluations are `ops.lgs.batched_lgs_multi` on the one
  adjacency with a remaining set per branch: one kernel launch with
  ``share = b`` on a card. A branch's score is summed in float64, where
  sums of float32 weights are exact: branches whose schedules have equal
  utility tie exactly and the first wins, as the JAX package's docstring
  promises (its float32 sums let the summation order pick among them).

All loops keep the reference's termination rule (stop when no node remains
or the remaining weight sum is <= 0) and its utility bookkeeping
``util = dot(nIS_vec, w)`` with nIS_vec in {-1, 0, 1}. Ties: the children
are taken by a stable descending sort (equal scores lowest index first, as
``jax.lax.top_k``), and ``argmax`` keeps the first maximum in both
packages.
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.agents import build_state_arrays
from distgcn_tpu_torch.core.graph import graph_fingerprint
from distgcn_tpu_torch.ops.lgs import (_round, batched_lgs,
                                       batched_lgs_multi, lgs_ranks)

NEG = -float("inf")


def _masked_forward(model, adj, wts, sel, mask, flags, feature_mode):
    """GCN forward on the remaining-node subgraph (masked, fixed shape):
    (act [B, N] zero off the remaining nodes, remain [B, N] bool)."""
    remain = (sel == -1) & mask
    rm = remain.to(wts.dtype)
    adj_m = adj * (remain[:, :, None] & remain[:, None, :]).to(adj.dtype)
    features, supports = build_state_arrays(
        adj_m, wts * rm, remain, flags.feature_size, flags.max_degree,
        flags.predict, feature_mode)
    out = model(features, supports)
    return out[..., 0] * rm, remain


def _commit(adjb, remain, win, sel):
    """Select `win`, exclude the remaining non-winners next to a winner."""
    excl = remain & ~win & (adjb & win[:, None, :]).any(dim=-1)
    sel = torch.where(win, torch.ones_like(sel), sel)
    return torch.where(excl, torch.zeros_like(sel), sel)


def _live(sel, mask, wts) -> bool:
    remain = (sel == -1) & mask
    return bool(remain.any()) and bool(
        torch.where(remain, wts, torch.zeros_like(wts)).sum() > 0)


def lgs_round_on_remaining(adjb, gcn_wts, sel, mask):
    """`ops.lgs._round` as one `batched_lgs` call: LGS on the remaining
    nodes with ``max_rounds=1``, merged as ``where(remain, out, sel)``
    (one kernel launch on a card)."""
    remain = (sel == -1) & mask
    out = batched_lgs(adjb, gcn_wts, remain, max_rounds=1)[0]
    return torch.where(remain, out, sel)


def dit_round(adjb, gcn_wts, sel, mask):
    """One DIT step's LGS round: `ops.lgs._round` on the CPU, the kernel
    through `lgs_round_on_remaining` on a card."""
    if gcn_wts.device.type == "cpu":
        return _round(adjb, lgs_ranks(gcn_wts), sel)
    return lgs_round_on_remaining(adjb, gcn_wts, sel, mask)


@torch.no_grad()
def run_dit(model, flags, feature_mode, adj, wts, mask):
    b, n = wts.shape
    sel = torch.where(mask, -1, 0).to(torch.int8)
    adjb = adj > 0     # booleanise outside the loop, as the JAX package
    it = 0
    while it < n and _live(sel, mask, wts):
        act, _ = _masked_forward(model, adj, wts, sel, mask, flags,
                                 feature_mode)
        gcn_wts = act * wts if flags.predict == "mwis" else act
        sel = dit_round(adjb, gcn_wts, sel, mask)
        it += 1
    return sel, (sel.to(wts.dtype) * wts).sum(dim=-1)


@torch.no_grad()
def run_cgs(model, flags, feature_mode, adj, wts, mask):
    b, n = wts.shape
    sel = torch.where(mask, -1, 0).to(torch.int8)
    adjb = adj > 0
    it = 0
    while it < n and _live(sel, mask, wts):
        act, remain = _masked_forward(model, adj, wts, sel, mask, flags,
                                      feature_mode)
        gcn_wts = act * wts if flags.predict == "mwis" else act
        scores = torch.where(remain, gcn_wts, torch.full_like(gcn_wts, NEG))
        pick = scores.argmax(dim=-1)                            # [B]
        onehot = torch.nn.functional.one_hot(pick, n).bool()
        # only commit in rows that still have remaining nodes
        win = onehot & remain.any(dim=-1, keepdim=True)
        sel = _commit(adjb, remain, win, sel)
        it += 1
    return sel, (sel.to(wts.dtype) * wts).sum(dim=-1)


def top_children(scores: torch.Tensor, b: int) -> torch.Tensor:
    """The `b` highest scores' indices, equal scores lowest index first
    (the order of ``jax.lax.top_k``; `torch.topk` promises none)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
    return order[..., :b]


@torch.no_grad()
def run_rollout(model, flags, feature_mode, adj, wts, mask, b_branches):
    bsz, n = wts.shape
    sel = torch.where(mask, -1, 0).to(torch.int8)
    adjb = adj > 0
    w64 = wts.to(torch.float64)
    it = 0
    while it < n and _live(sel, mask, wts):
        act, remain = _masked_forward(model, adj, wts, sel, mask, flags,
                                      feature_mode)
        gcn_wts = act * wts if flags.predict == "mwis" else act
        scores = torch.where(remain, gcn_wts, torch.full_like(gcn_wts, NEG))
        children = top_children(scores, b_branches)              # [B, b]
        child_valid = torch.gather(remain, -1, children)
        child_w = torch.gather(w64, -1, children)
        # per branch: the remainder without the child and its neighbours
        ch = torch.nn.functional.one_hot(children, n).bool()     # [B, b, N]
        nbr = (adjb[:, None, :, :] & ch[:, :, None, :]).any(dim=-1)
        rem_ro = remain[:, None, :] & ~ch & ~nbr
        guided = torch.where(rem_ro, wts[:, None, :],
                             torch.zeros_like(rem_ro, dtype=wts.dtype))
        done = batched_lgs_multi(adjb, guided, rem_ro)[0] == 1   # [B, b, N]
        # each branch's utility in float64: sums of float32 weights are
        # exact there, so branches whose schedules have equal utility tie
        # exactly and the first of them wins
        ev = torch.where(done, w64[:, None, :], 0.0).sum(dim=-1)  # [B, b]
        neg = torch.full_like(ev, NEG)
        evals = torch.where(child_valid, ev, neg)
        n_remain = remain.sum(dim=-1, keepdim=True)
        # rollout evaluation only with > 1 candidate (mwis_gdpg_call.py:
        # 628); with one remaining node the score is its weight alone
        total = torch.where(n_remain > 1, child_w + evals,
                            torch.where(child_valid, child_w, neg))
        i_best = total.argmax(dim=-1)                             # [B]
        pick = torch.gather(children, -1, i_best[:, None])[:, 0]
        win = (torch.nn.functional.one_hot(pick, n).bool()
               & remain.any(dim=-1, keepdim=True))
        sel = _commit(adjb, remain, win, sel)
        it += 1
    return sel, (sel.to(wts.dtype) * wts).sum(dim=-1)


# ---------------------------------------------------------------------------
# Host entry points used by agents.MWISSolver
# ---------------------------------------------------------------------------

def _run(agent, adj_0, wts_0, solve, *args) -> Tuple[set, float]:
    wts = np.asarray(wts_0, dtype=np.float64).flatten()
    n = wts.size
    # the same conflict graph arrives every slot in the wireless engine:
    # the device batch is cached by content (16 graphs), so only the
    # weights go up again
    gcache = getattr(agent, "_iter_gb_cache", None)
    if gcache is None:
        gcache = agent._iter_gb_cache = {}
    key = graph_fingerprint(adj_0)
    gb = gcache.get(key)
    if gb is None:
        if len(gcache) >= 16:
            gcache.pop(next(iter(gcache)))
        gb = gcache[key] = agent._to_batch(adj_0, np.zeros(n))
    w = np.zeros((1, gb.pad_n), dtype=np.float32)
    w[0, :n] = wts
    sel, util = solve(agent.model, agent.flags, agent.feature_mode, gb.adj,
                      torch.from_numpy(w).to(gb.adj.device), gb.mask, *args)
    sel = sel[0, :n].cpu().numpy()
    return set(np.nonzero(sel == 1)[0].tolist()), float(util[0])


def solve_dit(agent, adj_0, wts_0) -> Tuple[set, float]:
    return _run(agent, adj_0, wts_0, run_dit)


def solve_cgs(agent, adj_0, wts_0) -> Tuple[set, float]:
    return _run(agent, adj_0, wts_0, run_cgs)


def solve_rollout(agent, adj_0, wts_0, b: int = 16) -> Tuple[set, float]:
    return _run(agent, adj_0, wts_0, run_rollout, b)


def solve_cgs_episodic(agent, adj_0, wts_0, train: bool = False,
                       grd: float = 1.0) -> Tuple[set, float]:
    """Training variant of CGS with per-step memorization and backtracked
    discounted rewards (mwis_gdpg_call.py:778-839). A host loop (it
    memorizes per-step states) with one device forward per step."""
    adj = sp.csr_matrix(adj_0)
    wts = np.asarray(wts_0, dtype=np.float64).flatten()
    n = wts.size
    sel = -np.ones(n)
    buffers = deque(maxlen=500)
    while (sel == -1).any():
        remain = sel == -1
        if wts[remain].sum() <= 0:
            break
        ridx = np.nonzero(remain)[0]
        sub = adj[ridx][:, ridx]
        state = agent.makestate(sub, wts[ridx].reshape(-1, 1))
        act_vals, _ = agent.act(state, train)
        gcn_wts = agent._gcn_weights(act_vals, wts[ridx])
        pick = int(np.argmax(gcn_wts))
        v = ridx[pick]
        sel[v] = 1
        nbrs = adj.indices[adj.indptr[v]: adj.indptr[v + 1]]
        nbrs = nbrs[sel[nbrs] == -1]
        sel[nbrs] = 0
        if train:
            buffers.append((state, act_vals.copy(), pick))
    util = float(np.dot(sel, wts))
    mwis = set(np.nonzero(sel == 1)[0].tolist())
    if train:
        reward = util / grd
        next_state = {}
        agent.reward_mem.append(reward)
        for i in reversed(range(len(buffers))):
            if i == len(buffers) - 1:
                reward = util / grd
            else:
                reward = reward * agent.gamma
            state, act_vals, action = buffers[i]
            agent.memorize(state, act_vals, [action], next_state, reward)
            next_state = state
    return mwis, util
