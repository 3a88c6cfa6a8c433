"""`_BsfSearch.absorb` (whole-array passes over a device call's states and
heads) against `_absorb_heads` (the JAX package's per-head loop, kept here
as the yardstick) on seeded random states, with weights whose sums are
exact in every order (one product) and with float64 weights (numpy's sum
head by head), and the exactness rule `exact_sums` that chooses between
the two sums.

Everything is compared exactly: the best set and utility, the heap's list,
`seen`, the push counter and the generator's next draw. Where the batch
takes the search's last pops the heap, `seen` and the counter are left out:
the search is done after it, nothing reads them again, and `absorb` builds
no children there.
"""

from __future__ import annotations

import copy
import heapq

import numpy as np
import pytest
import scipy.sparse as sp

from distgcn_tpu_torch import agents_extra
from distgcn_tpu_torch.agents_extra import DiverAgent, _BsfSearch, exact_sums

# 32 heads as published: numpy sorts that many heads' maxima unstably
D, NOOUT = 32, 24


def _graph(rng, n, p=0.2):
    a = np.triu(rng.random((n, n)) < p, 1)
    return sp.csr_matrix((a | a.T).astype(np.float32))


def _absorb_heads(s, batch, sels, probs_l):
    """`absorb` head by head: the JAX package's loop line for line."""
    adj, wts = s.adj, s.wts
    for (nis, rem_idx, fixed_idx, fixed_util), sel, probs in zip(
            batch, sels, probs_l):
        order = np.argsort(-probs.max(axis=0))[: s.noout]
        for k in order:
            chosen = np.nonzero(sel[k] == 1)[0]       # global ids
            if chosen.size == 0:
                continue
            comp = set(chosen.tolist())
            util = fixed_util + float(wts[chosen].sum())
            if util > s.best_util:
                s.best_util = util
                s.best_set = set(fixed_idx.tolist()) | comp
            if s.rng.random() >= s.backoff:
                continue
            # branch on the head's highest-scored selected node
            v = int(chosen[np.argmax(probs[chosen, k])])
            # deepen: fix v in, exclude its neighbors
            child = nis.copy()
            child[v] = 1
            nbrs = adj.indices[adj.indptr[v]: adj.indptr[v + 1]]
            child[nbrs[child[nbrs] == -1]] = 0
            b = child.tobytes()
            if b not in s.seen:
                s.seen.add(b)
                heapq.heappush(s.heap, (-util, s.counter, b))
                s.counter += 1
            # backoff: exclude v
            child2 = nis.copy()
            child2[v] = 0
            b2 = child2.tobytes()
            if b2 not in s.seen:
                s.seen.add(b2)
                heapq.heappush(s.heap, (-util, s.counter, b2))
                s.counter += 1


def _pair(adj, wts, batch_pops, max_pops, seed):
    """Two searches alike: one for `absorb`, one for `_absorb_heads`."""
    return [_BsfSearch(adj, wts, max_pops, batch_pops, NOOUT, 0.5,
                       np.random.default_rng(seed)) for _ in range(2)]


def _states(rng, n, q, case, exact=True):
    """q popped states (labels, remaining, fixed, fixed utility) and their
    sels [D, n] int8 / probs [n, D] float32, shaped to hit `case`; float32
    weights (`exact`) or float64 ones."""
    wts = rng.random(n)
    if exact:
        wts = wts.astype(np.float32).astype(np.float64)
    if case == "ties_util":
        # equal utilities: the same values summed in the same order
        wts = (rng.integers(1, 3, n).astype(np.float64) if exact
               else rng.choice(np.array([0.1, 0.3]), n))
    batch, sels, probs = [], [], []
    for _ in range(q):
        nis = rng.choice(np.array([-1, -1, -1, 0, 1], np.int8), n)
        rem = np.nonzero(nis == -1)[0]
        fixed = np.nonzero(nis == 1)[0]
        batch.append((nis, rem, fixed, float(wts[fixed].sum())))
        sel = np.zeros((D, n), np.int8)
        sel[:, rem] = rng.random((D, rem.size)) < 0.4
        p = rng.random((n, D)).astype(np.float32)
        if case in ("ties_max", "ties_chosen"):
            # few levels: heads' maxima and chosen probabilities tie
            p = np.floor(p * (2 if case == "ties_max" else 3)) / 4
            p = p.astype(np.float32)
        elif case == "empty":
            sel[rng.random(D) < 0.5] = 0
        elif case == "shared_branch":
            # heads 0 and 1 branch on one node: one child pair is a repeat
            sel[1], p[:, 1] = sel[0], p[:, 0]
        p[nis != -1] = 0.0
        sels.append(sel)
        probs.append(p)
    return wts, batch, sels, probs


def _snapshot(s, ending):
    out = [s.best_set, s.best_util, s.rng.random()]
    if not ending:
        out += [s.heap, s.seen, s.counter]
    return out


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("ending", [False, True])
@pytest.mark.parametrize("batch_pops", [1, 4, 8])
@pytest.mark.parametrize("case", ["ties_max", "ties_chosen", "ties_util",
                                  "empty", "shared_branch"])
def test_absorb_equals_the_per_head_loop(case, batch_pops, ending, exact):
    rng = np.random.default_rng([batch_pops, ending, len(case), exact])
    pushed = 0
    for trial in range(6):
        n = int(rng.integers(8, 40))
        wts, batch, sels, probs = _states(rng, n, batch_pops, case, exact)
        adj = _graph(rng, n)
        max_pops = 3 * batch_pops
        fast, slow = _pair(adj, wts, batch_pops, max_pops, trial)
        assert fast.exact is exact
        if trial % 3 == 2:
            # the best so far ties the batch's best: the earlier set stays
            dry = copy.deepcopy(slow)
            _absorb_heads(dry, batch, sels, probs)
        for s in (fast, slow):
            # the batch's pops taken: the last ones, or some remain
            s.pops = max_pops if ending else batch_pops
            if trial % 3 == 1:
                s.best_util = 0.5 * float(wts.sum())  # a candidate to beat
            elif trial % 3 == 2:
                s.best_set, s.best_util = {-1}, dry.best_util
            # earlier pushes: every backoff child of the first state
            for v in batch[0][1]:
                child = batch[0][0].copy()
                child[v] = 0
                s.seen.add(child.tobytes())
        before = fast.counter
        fast.absorb(batch, sels, probs)
        _absorb_heads(slow, batch, sels, probs)
        assert _snapshot(fast, ending) == _snapshot(slow, ending)
        assert type(fast.best_util) is type(slow.best_util)
        pushed += fast.counter - before
        if ending:
            assert fast.counter == before and len(fast.heap) == 1
    if not ending:
        assert pushed > 0


@pytest.mark.parametrize("weights, exact", [
    ("float32_uniform", True),
    ("float64_uniform", False),
    ("float32_1e-12_to_1e3", False),
    ("whole_numbers", True),
    ("zeros", True),
    ("negative_zero", False),
    ("nan", False),
    ("inf", False),
])
def test_exact_sums(weights, exact):
    rng = np.random.default_rng(1)
    w = {"float32_uniform": rng.random(256).astype(np.float32),
         "float64_uniform": rng.random(256),
         "float32_1e-12_to_1e3": np.float32(10.0) ** rng.uniform(
             -12, 3, 256).astype(np.float32),
         "whole_numbers": rng.integers(0, 1000, 256).astype(np.float64),
         "zeros": np.zeros(16),
         "negative_zero": np.array([1.0, -0.0, 2.0]),
         "nan": np.array([1.0, np.nan]),
         "inf": np.array([1.0, np.inf])}[weights]
    assert exact_sums(w) is exact


@pytest.mark.parametrize("weights", ["float32", "float64",
                                     "float32_1e-12_to_1e3"])
def test_fallback_and_children_are_counted(weights, monkeypatch):
    rng = np.random.default_rng(7)
    n, q = 30, 4
    wts32, batch, sels, probs = _states(rng, n, q, "ties_chosen")
    wts = {"float32": wts32, "float64": rng.random(n),
           "float32_1e-12_to_1e3": np.float32(10.0) ** rng.uniform(
               -12, 3, n).astype(np.float32)}[weights]
    adj = _graph(rng, n)
    fast, slow = _pair(adj, wts, q, 4 * q, 2)
    pushes = []
    real = heapq.heappush

    def counted(heap, item):
        pushes.append(item)
        real(heap, item)
    monkeypatch.setattr(agents_extra.heapq, "heappush", counted)
    states, children = DiverAgent.bsf_fallback_states, DiverAgent.bsf_children
    for s in (fast, slow):
        s.pops = q
    fast.absorb(batch, sels, probs)
    assert fast.exact is (weights == "float32")
    assert DiverAgent.bsf_fallback_states - states == (
        0 if fast.exact else q)
    assert DiverAgent.bsf_children - children == len(pushes) > 0
    _absorb_heads(slow, batch, sels, probs)
    assert _snapshot(fast, False) == _snapshot(slow, False)
