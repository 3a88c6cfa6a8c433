"""Port parity: the iterative solvers (DIT, CGS, rollout) and the episodic
CGS trainer against the JAX package's `solvers/iterative.py`.

The JAX agent and the port's agent hold the same parameters (carried over
with `params_from_jax`). Selections are bit-equal and utilities within
rtol 1e-5 (the rule of `tests/test_torch_pipeline.py`); the episodic CGS
memorizes the same actions and rewards. DIT's card route (one LGS call
with ``max_rounds=1`` on the remaining nodes, merged) is held against
`ops.lgs._round` here with the plain version; the kernel itself runs only
on the card.

The rollout scores a branch by the utility of its schedule. Different
children often lead to the same schedule, so equal scores are common. The
port sums them in float64 (exact for float32 weights), so equal schedules
tie and the first branch wins, as the JAX docstring promises; the JAX
package sums in float32, where the summation order decides among them.
The parity cases of the rollout therefore use weights in multiples of
2^-8, whose float32 sums are exact in any order; on random weights the
port is held against an exact-arithmetic oracle built from the JAX
package's own GCN forward and LGS (`_rollout_oracle`).
"""

import numpy as np
import pytest
import torch

from conftest import random_graph
from distgcn_tpu.agents import DQNAgent as JDQNAgent
from distgcn_tpu.solvers import iterative as jit_
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.models.gcn import params_from_jax
from distgcn_tpu_torch.ops.lgs import _round, lgs_ranks
from distgcn_tpu_torch.solvers import iterative
from distgcn_tpu_torch.utils.config import Config

BASE = dict(feature_size=1, hidden1=8, diver_num=1, max_degree=1,
            predict="mwis", epsilon=0.0, pad_to=64, learning_rate=1e-3)


def _agents(family="gcn2_dqn", num_layer=2, seed=0, **kw):
    cfg = dict(BASE, num_layer=num_layer, **kw)
    jag = JDQNAgent(JConfig(**cfg), model_family=family, seed=seed)
    tag = DQNAgent(Config(**cfg), model_family=family, seed=seed,
                   device="cpu")
    tag.model.load_state_dict(params_from_jax(jag.params))
    return jag, tag


def _graphs(rng, k=4, lo=20, hi=60, p=0.12):
    out = []
    for _ in range(k):
        n = int(rng.integers(lo, hi + 1))
        out.append((random_graph(rng, n, p), rng.random(n)))
    return out


def _check_is(adj, sel):
    idx = sorted(sel)
    assert adj[idx][:, idx].nnz == 0


def _dyadic(w):
    """Weights in multiples of 2^-8 in (0, 1]: float32 sums are exact."""
    return np.ceil(np.asarray(w) * 256) / 256


SOLVERS = {
    "dit": (jit_.solve_dit, iterative.solve_dit, {}),
    "cgs": (jit_.solve_cgs, iterative.solve_cgs, {}),
    "rollout4": (jit_.solve_rollout, iterative.solve_rollout, {"b": 4}),
    "rollout16": (jit_.solve_rollout, iterative.solve_rollout, {"b": 16}),
}


@pytest.mark.parametrize("family", ["gcn_dqn", "gcn2_dqn"])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_iterative_solvers_match_jax(rng, solver, family):
    jfn, tfn, kw = SOLVERS[solver]
    jag, tag = _agents(family)
    for a, w in _graphs(rng):
        if solver.startswith("rollout"):
            w = _dyadic(w)
        jsel, jutil = jfn(jag, a, w, **kw)
        tsel, tutil = tfn(tag, a, w, **kw)
        _check_is(a, tsel)
        assert tsel == jsel
        assert tutil == pytest.approx(jutil, rel=1e-5)


@pytest.mark.parametrize("predict", ["mwis", "dqn"])
def test_iterative_solvers_match_jax_on_ragged_batch_cache(rng, predict):
    """The device-batch cache: a graph seen twice reuses its batch; DIT and
    rollout agree with JAX on both passes, predict modes mwis and dqn."""
    jag, tag = _agents("gcn_dqn", num_layer=3, predict=predict)
    graphs = _graphs(rng, k=2, lo=30, hi=50)
    for a, w in graphs + graphs:
        w = _dyadic(w)
        for name in ("dit", "rollout4"):
            jfn, tfn, kw = SOLVERS[name]
            jsel, jutil = jfn(jag, a, w, **kw)
            tsel, tutil = tfn(tag, a, w, **kw)
            assert tsel == jsel
            assert tutil == pytest.approx(jutil, rel=1e-5)
    assert len(tag._iter_gb_cache) == 2


def test_rollout_with_tied_scores_matches_jax(rng):
    """All GCN outputs equal and all weights equal: every child scores the
    same, so the children and the best branch come from the tie order
    (lowest index first in both packages)."""
    jag, tag = _agents("gcn2_dqn", num_layer=2)
    zero = {k: np.zeros_like(v) for k, v in jag.params["gc2"].items()}
    zero["bias"] = np.ones_like(zero["bias"])
    jag.params = dict(jag.params, gc2=zero)
    tag.model.load_state_dict(params_from_jax(jag.params))
    for a, w in _graphs(rng, k=3):
        w = np.ones_like(w)
        for b in (4, 16):
            jsel, jutil = jit_.solve_rollout(jag, a, w, b=b)
            tsel, tutil = iterative.solve_rollout(tag, a, w, b=b)
            assert tsel == jsel
            assert tutil == pytest.approx(jutil, rel=1e-5)


def test_top_children_tie_order():
    scores = torch.tensor([[0.5, 1.0, 0.5, 1.0, -float("inf"), 0.5,
                            -float("inf")]])
    got = iterative.top_children(scores, 6)
    assert got.tolist() == [[1, 3, 0, 2, 5, 4]]


def test_dit_card_route_equals_round(rng):
    """DIT's card route (LGS on the remaining nodes, max_rounds=1, merged)
    equals `_round` with ranks over all nodes, through a solve's states."""
    for a, w in _graphs(rng, k=4):
        n = a.shape[0]
        adj = torch.from_numpy(a.toarray() > 0)[None]
        pad = 64
        adjb = torch.zeros((1, pad, pad), dtype=torch.bool)
        adjb[:, :n, :n] = adj
        mask = torch.zeros((1, pad), dtype=torch.bool)
        mask[0, :n] = True
        sel = torch.where(mask, -1, 0).to(torch.int8)
        g = torch.Generator().manual_seed(n)
        while bool((sel == -1).any()):
            gw = torch.rand((1, pad), generator=g) - 0.2
            gw[0, rng.integers(0, n, 4)] = 0.25      # some ties
            want = _round(adjb, lgs_ranks(gw), sel)
            got = iterative.lgs_round_on_remaining(adjb, gw, sel, mask)
            assert torch.equal(got, want)
            sel = want


def test_agent_hooks_route_to_the_solvers(rng):
    jag, tag = _agents("gcn2_dqn")
    a, w = _graphs(rng, k=1)[0]
    w = _dyadic(w)
    assert tag.solve_mwis_dit(a, w) == jag.solve_mwis_dit(a, w)
    assert tag.solve_mwis_cit(a, w)[0] == jag.solve_mwis_cit(a, w)[0]
    assert tag.solve_mwis_cit_wrap(a, w)[0] == \
        jag.solve_mwis_cit_wrap(a, w)[0]
    for b in (4, 16):
        assert tag.solve_mwis_rollout_wrap(a, w, b=b)[0] == \
            jag.solve_mwis_rollout_wrap(a, w, b=b)[0]


def test_cgs_episodic_train_matches_jax_memory(rng):
    jag, tag = _agents("gcn2_dqn", gamma=0.9)
    for a, w in _graphs(rng, k=3):
        jsel, jutil = jag.solve_mwis_cgs_train(a, w, train=True, grd=2.0)
        tsel, tutil = tag.solve_mwis_cgs_train(a, w, train=True, grd=2.0)
        assert tsel == jsel
        assert tutil == pytest.approx(jutil, rel=1e-12)
    assert len(tag.memory) == len(jag.memory) > 0
    for (ts, tav, tact, tnext, trew), (js, jav, jact, jnext, jrew) in zip(
            tag.memory, jag.memory):
        assert (ts["adj"] != js["adj"]).nnz == 0
        np.testing.assert_array_equal(ts["wts"], js["wts"])
        np.testing.assert_allclose(tav, jav, rtol=1e-5, atol=1e-7)
        assert tact == jact
        assert trew == pytest.approx(jrew, rel=1e-12)
        assert (tnext == {}) == (jnext == {})
    np.testing.assert_allclose(list(tag.reward_mem), list(jag.reward_mem))


def _rollout_oracle(jag, a, w, b):
    """The rollout with the JAX package's GCN forward and LGS, each
    branch's utility summed exactly (float64) and ties to the first
    branch: the semantics the JAX docstring states."""
    import jax.numpy as jnp
    from distgcn_tpu.ops.lgs import batched_lgs as jlgs
    gb = jag._to_batch(a, np.zeros(a.shape[0]))
    n, pad = a.shape[0], gb.pad_n
    w32 = np.zeros((1, pad), np.float32)
    w32[0, :n] = w
    w64 = w32[0].astype(np.float64)
    adj = np.asarray(gb.adj[0]) > 0
    mask = np.asarray(gb.mask[0])
    sel = np.where(mask, -1, 0).astype(np.int8)
    while True:
        remain = (sel == -1) & mask
        if not remain.any() or w32[0][remain].sum() <= 0:
            break
        act, _ = jit_._masked_forward(
            jag.model, jag.params, gb.adj, jnp.asarray(w32),
            jnp.asarray(sel[None]), gb.mask, jag.flags, jag.feature_mode)
        scores = np.where(remain, np.asarray(act)[0] * w32[0], -np.inf)
        children = np.argsort(-scores, kind="stable")[:b]
        totals = []
        for c in children:
            if not remain[c]:
                totals.append(-np.inf)
                continue
            if remain.sum() == 1:
                totals.append(w64[c])
                continue
            rem = remain & ~adj[:, c]
            rem[c] = False
            s = np.asarray(jlgs(gb.adj, jnp.asarray(
                np.where(rem, w32[0], 0)[None]), jnp.asarray(rem[None]))[0])
            totals.append(w64[c] + w64[s[0] == 1].sum())
        v = children[int(np.argmax(totals))]
        excl = remain & adj[:, v]
        sel[v] = 1
        sel[excl & (np.arange(pad) != v)] = 0
    return set(np.nonzero(sel[:n] == 1)[0].tolist())


def test_rollout_matches_exact_tie_oracle_on_random_weights(rng):
    """On random weights the port's rollout equals the exact-arithmetic
    oracle. The JAX package does not on the first graph: branches whose
    schedules have the same utility get float32 totals one unit in the
    last place apart, and the later branch wins (the fault ROADMAP §C
    records: expected utility 11.360377, JAX 11.257884)."""
    jag, tag = _agents("gcn_dqn")
    for i, (a, w) in enumerate(_graphs(rng)):
        want = _rollout_oracle(jag, a, w, 4)
        got, util = iterative.solve_rollout(tag, a, w, b=4)
        assert got == want
        assert util == pytest.approx(float(np.sum(w[list(want)])),
                                     rel=1e-6)
        if i == 0:
            jsel, jutil = jit_.solve_rollout(jag, a, w, b=4)
            assert jsel != want
            assert util == pytest.approx(11.360377, abs=1e-5)
            assert jutil == pytest.approx(11.257884, abs=1e-5)
