"""The graph-set evaluation path on the card against the same path on the
CPU: the iterative solvers, the diver searches and the supervised diver
step.

Card tests (`-m cuda`; they skip without a card). This file imports only
the port, so it collects where flax is absent. On the card DIT's round is
one launch of kernel B1 on the remaining nodes, each rollout step one
launch with ``share = b`` and each diver pop batch one launch with
``share = D``; the CPU runs the plain versions. Tolerances: selections
bit-equal (B1 is bit-equal to the plain LGS and the f32 scores agree to
~1e-6), head scores within rtol 1e-5, the supervised loss within rtol
1e-5 and the parameters after one TF1 Adam step within 2·lr + rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from conftest import random_graph
from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.agents_extra import DiverAgent
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.agents import build_state_arrays
from distgcn_tpu_torch.ops.lgs import _round, lgs_ranks
from distgcn_tpu_torch.ops.lgs_cuda import batched_lgs_kernel
from distgcn_tpu_torch.rl.train import (make_optimizer,
                                        make_supervised_diver_step)
from distgcn_tpu_torch.solvers import iterative
from distgcn_tpu_torch.utils.config import Config

LR = 1e-3
CFG = dict(feature_size=1, hidden1=8, num_layer=3, max_degree=1,
           predict="mwis", epsilon=0.0, pad_to=64, learning_rate=LR)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(cls, cuda, **kw):
    cfg = Config(**dict(CFG, **kw))
    cpu = cls(cfg, device="cpu", seed=3)
    card = cls(cfg, device=cuda, seed=3)
    card.model.load_state_dict(cpu.model.state_dict())
    return cpu, card


def _graphs(rng, k=3):
    out = []
    for _ in range(k):
        n = int(rng.integers(30, 61))
        out.append((random_graph(rng, n, 0.12), rng.random(n)))
    return out


@pytest.mark.cuda
def test_dit_round_on_card_equals_round(cuda, rng):
    n, pad = 57, 64
    adjb = torch.zeros((4, pad, pad), dtype=torch.bool)
    for i in range(4):
        adjb[i, :n, :n] = torch.from_numpy(
            random_graph(rng, n, 0.15).toarray() > 0)
    mask = torch.zeros((4, pad), dtype=torch.bool)
    mask[:, :n] = True
    sel = torch.where(mask, -1, 0).to(torch.int8)
    g = torch.Generator().manual_seed(0)
    while bool((sel == -1).any()):
        gw = torch.rand((4, pad), generator=g) - 0.2
        want = _round(adjb, lgs_ranks(gw), sel)
        before = batched_lgs_kernel.launches
        got = iterative.dit_round(adjb.to(cuda), gw.to(cuda), sel.to(cuda),
                                  mask.to(cuda))
        assert batched_lgs_kernel.launches == before + 1
        assert torch.equal(got.cpu(), want)
        sel = want


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dit", "cgs", "rollout"])
def test_iterative_solvers_on_card_match_cpu(cuda, rng, solver):
    cpu, card = _pair(DQNAgent, cuda, diver_num=1)
    fn = {"dit": iterative.solve_dit, "cgs": iterative.solve_cgs,
          "rollout": lambda ag, a, w: iterative.solve_rollout(ag, a, w, 8)
          }[solver]
    for a, w in _graphs(rng):
        before = batched_lgs_kernel.launches
        got, gutil = fn(card, a, w)
        launches = batched_lgs_kernel.launches - before
        want, wutil = fn(cpu, a, w)
        assert got == want
        assert gutil == pytest.approx(wutil, rel=1e-5)
        if solver == "rollout":
            assert launches == len(got)   # one share=8 launch a step
        elif solver == "cgs":
            assert launches == 0


@pytest.mark.cuda
def test_diver_searches_on_card_match_cpu(cuda, rng):
    cpu, card = _pair(DiverAgent, cuda, diver_num=4, backoff_prob=0.6)
    graphs = _graphs(rng, k=4)
    for a, w in graphs[:2]:
        np.testing.assert_allclose(
            card.head_scores(card.makestate(a, w.reshape(-1, 1))),
            cpu.head_scores(cpu.makestate(a, w.reshape(-1, 1))),
            rtol=1e-5, atol=1e-7)
        assert card.solve_mwis_iterative(a, w) == \
            cpu.solve_mwis_iterative(a, w)
    got = card.solve_mwis_bsf_many(graphs, max_pops=8, batch_pops=4,
                                   group=2)
    want = cpu.solve_mwis_bsf_many(graphs, max_pops=8, batch_pops=4,
                                   group=2)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([u for _, u in got], [u for _, u in want],
                               rtol=1e-12)


@pytest.mark.cuda
def test_supervised_diver_step_on_card_matches_cpu(cuda, rng):
    cpu, card = _pair(DiverAgent, cuda, diver_num=3)
    adjs = [random_graph(rng, n, 0.15) for n in (25, 40, 61)]
    wtss = [rng.random(a.shape[0]) for a in adjs]
    labels = (rng.random((3, 64)) < 0.3).astype(np.float32)
    losses, states = [], []
    for ag in (cpu, card):
        gb = GraphBatch.from_scipy(adjs, wtss, pad_to=64, device=ag.device)
        feats, sups = build_state_arrays(gb.adj, gb.wts, gb.mask, 1, 1,
                                         "mwis", "gdpg")
        opt = make_optimizer(LR)
        step = make_supervised_diver_step(ag.model, opt, 3)
        _, loss = step(opt.init(dict(ag.model.named_parameters())), feats,
                       sups, gb.mask,
                       torch.from_numpy(labels).to(ag.device), gb.wts)
        losses.append(float(loss))
        states.append({k: v.detach().cpu()
                       for k, v in ag.model.state_dict().items()})
    assert np.isfinite(losses).all()
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for k, v in states[0].items():
        excess = ((states[1][k] - v).abs() - 1e-4 * v.abs()).max()
        assert float(excess) <= 2 * LR, k
