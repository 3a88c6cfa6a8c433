"""`large.bsr_lgs`'s batches of rounds (plain passes, on the CPU) against
a loop that reads the nodes left once a round.

The host enqueues a batch of rounds and reads their counts once; a round
after the count reaches 0 is gated and changes nothing. So sel, util's
bits and rounds must equal the one-read-a-round loop's for every first
batch, which the tests force through the graph's solve state
(``LargeGraph.lgs_state.rounds``: the first batch is it + 1), and the
counters must add up. The gated kernel passes are held to the same on
the card (`tests/test_torch_large_kernels.py`).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distgcn_tpu_torch import large
from distgcn_tpu_torch.ops import spmm
from distgcn_tpu_torch.ops.lgs import lgs_ranks

N, BS = 300, 128
_GRAPHS = {}


def _graph(isolated):
    """A geometric graph of N links on bitmap blocks of BS (every 9th
    link isolated if asked) and its weights padded to n_pad."""
    if isolated not in _GRAPHS:
        adj, wts, _ = large.geometric_conflict_graph(N, avg_degree=12.0,
                                                     seed=5)
        if isolated:
            keep = np.arange(N) % 9 != 0
            adj = sp.csr_matrix(adj.multiply(keep[:, None]).multiply(keep))
            adj.eliminate_zeros()
        g = large.build_large_graph(adj, block_size=BS, use_bsr=True,
                                    device="cpu")
        assert g.bitmap
        w = torch.zeros(g.n_pad)
        w[:N] = torch.from_numpy(wts)
        _GRAPHS[isolated] = (g, w)
    return _GRAPHS[isolated]


def _case(case):
    """(graph, weights, mask, max_rounds) of a case; the mask is the
    graph's own where the case leaves it."""
    g, w = _graph(case == "isolated")
    mask, max_rounds = g.mask, None
    if case == "ties":
        w = torch.round(w * 4) / 4           # many ties: broken by node id
    elif case == "max_rounds":
        max_rounds = 2
    elif case == "masked":
        mask = g.mask & (torch.arange(g.n_pad) % 5 != 0)
    elif case == "zero_weights":
        w = torch.zeros_like(w)
    elif case == "empty_mask":
        mask = torch.zeros_like(g.mask)
    return g, w, mask, max_rounds


def _one_read_a_round(g, wts, mask, max_rounds=None):
    """The LGS rounds composed from `bsr_nbr_max_plain` and element-wise
    ops, the nodes left read by the host after every round."""
    ind = g.ind_bsr
    ranks = lgs_ranks(wts).to(torch.float32)
    sel = torch.where(mask, -1, 0).to(torch.int8)
    cap = wts.shape[0] if max_rounds is None else max_rounds

    def nbr_max(x):
        return spmm.bsr_nbr_max_plain(ind.blk_vals, g.ind_row_ptr,
                                      ind.blk_cols, x, ind.n_rows,
                                      ind.block_size, True)

    r = 0
    while r < cap and bool((sel == -1).any()):
        remain = sel == -1
        win = remain & (ranks > nbr_max(torch.where(remain, ranks, -1.0)))
        hit = nbr_max(win.to(torch.float32)) > 0.0
        sel = torch.where(win, torch.ones_like(sel), sel)
        sel = torch.where(remain & ~win & hit, torch.zeros_like(sel), sel)
        r += 1
    return sel, torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(), r


def _expected_batches(first, cap, rounds):
    """(reads, rounds enqueued) of a solve of `rounds` rounds whose first
    batch is `first`, by `large.lgs_batches`."""
    reads = enqueued = 0
    if rounds == 0:
        return 0, 0
    for k in large.lgs_batches(first, cap):
        reads, enqueued = reads + 1, enqueued + k
        if enqueued >= rounds:
            break
    return reads, enqueued


def _counted_passes(g):
    """Count the passes the graph's `bsr_lgs` state runs: [launches]."""
    launches = [0]

    def counted(fn):
        def run(prev, cur):
            launches[0] += 1
            fn(prev, cur)
        return run

    g.lgs_state.passes = tuple(counted(fn) for fn in g.lgs_state.passes)
    return launches


CASES = ["random", "ties", "max_rounds", "isolated", "masked",
         "zero_weights", "empty_mask"]
FIRSTS = ["1", "2", "rounds-1", "rounds", "rounds+3", "over_cap"]


@pytest.mark.parametrize("first", FIRSTS)
@pytest.mark.parametrize("case", CASES)
def test_bsr_lgs_batches_bit_equal_to_one_read_a_round(case, first):
    g, w, mask, max_rounds = _case(case)
    psel, putil, prounds = _one_read_a_round(g, w, mask, max_rounds)
    cap = w.shape[0] if max_rounds is None else max_rounds
    forced = {"1": 1, "2": 2, "rounds-1": max(prounds - 1, 1),
              "rounds": max(prounds, 1), "rounds+3": prounds + 3,
              "over_cap": cap + 7}[first]
    large.bsr_lgs(g, w, mask, max_rounds)      # the state, its ring used
    g.lgs_state.rounds = forced - 1
    bound = g.lgs_state.passes
    launches = _counted_passes(g)
    before = (large.bsr_lgs.reads, large.bsr_lgs.rounds_enqueued,
              large.bsr_lgs.rounds)
    sel, util, rounds = large.bsr_lgs(g, w, mask, max_rounds)
    g.lgs_state.passes = bound
    reads, enqueued, worked = (large.bsr_lgs.reads - before[0],
                               large.bsr_lgs.rounds_enqueued - before[1],
                               large.bsr_lgs.rounds - before[2])
    assert sel.dtype == torch.int8 and torch.equal(sel, psel)
    assert torch.equal(util.view(torch.int32), putil.view(torch.int32))
    assert int(rounds) == prounds == worked == g.lgs_state.rounds
    assert launches[0] == 2 * enqueued
    assert worked <= enqueued <= cap
    assert (reads, enqueued) == _expected_batches(forced, cap, prounds)
    assert not sel[~mask].any()
    if max_rounds is None:
        assert not (sel[mask] == -1).any()
    if case == "max_rounds":
        assert prounds == 2 and (psel[mask] == -1).any()   # cut short


def test_bsr_lgs_rounds_past_the_ring():
    """Ties broken by node id along a path of links: more rounds than the
    ring has slots, so the counts wrap around it between reads."""
    n = 160
    adj = sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1],
                   shape=(n, n), format="csr")
    g = large.build_large_graph(adj, block_size=32, use_bsr=True,
                                device="cpu")
    w = torch.zeros(g.n_pad)
    w[:n] = torch.arange(n, dtype=torch.float32)   # each round one link
    psel, putil, prounds = _one_read_a_round(g, w, g.mask)
    assert prounds > 2 * large.LGS_RING
    for _ in range(2):                       # the first solve, then warm
        sel, util, rounds = large.bsr_lgs(g, w, g.mask)
        assert torch.equal(sel, psel) and int(rounds) == prounds
        assert torch.equal(util.view(torch.int32), putil.view(torch.int32))


@pytest.mark.parametrize("kind", ["rank", "spread"])
def test_gated_plain_pass_changes_nothing(kind):
    """A pass whose previous count is 0 leaves key, win and sel as they
    were, and of left only the rank pass's zeroed slot differs; with the
    count open the same pass changes them."""
    g, w = _graph(False)
    ind = g.ind_bsr
    gen = torch.Generator().manual_seed(3)
    key = lgs_ranks(w).to(torch.float32)
    key[torch.rand(g.n_pad, generator=gen) < 0.3] = -1.0
    win = (torch.rand(g.n_pad, generator=gen) < 0.2).to(torch.float32)
    sel = torch.where(key >= 0, -1, 0).to(torch.int8)
    left = torch.tensor([0, 7, 9, 11], dtype=torch.int32)
    passes = spmm.lgs_round_passes(ind.blk_vals, g.ind_row_ptr,
                                   ind.blk_cols, key, win, sel, left,
                                   ind.n_rows, ind.block_size, True)
    run = passes[0] if kind == "rank" else passes[1]
    state = [t.clone() for t in (key, win, sel)]
    run(0, 1)
    for got, was in zip((key, win, sel), state):
        assert torch.equal(got, was)
    want = [0, 0, 9, 11] if kind == "rank" else [0, 7, 9, 11]
    assert left.tolist() == want
    run(2, 3)                                # open: left[2] = 9
    assert any(not torch.equal(got, was)
               for got, was in zip((key, win, sel), state))
    assert left.tolist()[3] != 11 and left.tolist()[:3] == want[:3]


def test_bsr_lgs_results_outlive_the_graphs_next_solve():
    """The rounds' state is the graph's and is reused by its next solve;
    what a solve returned stays as it was."""
    g, w = _graph(False)
    first = large.bsr_lgs(g, w, g.mask)
    kept = [t.clone() for t in first]
    large.bsr_lgs(g, torch.flip(w, [0]) * g.mask, g.mask)
    for got, was in zip(first, kept):
        assert torch.equal(got, was)
    assert not torch.equal(first[0], large.bsr_lgs(
        g, torch.flip(w, [0]) * g.mask, g.mask)[0])
