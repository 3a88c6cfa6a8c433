"""The plain reference against the port on the CPU at tiny sizes (the
test imports the port; the reference does not)."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bench_h100 import graphs
from bench_h100.reference import checkpoint, dense, large, lgs, precision
from bench_h100.reference import traffic as ref_traffic
from bench_h100.tests import tiny
from distgcn_tpu_torch.large import (build_large_graph, large_gcn_forward,
                                     make_large_closed_loop, params_to_list)
from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.ops.lgs import batched_lgs_plain, ell_lgs
from distgcn_tpu_torch.sim.device_sim import _traffic, make_closed_loop
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.serialization import load_params

CPU = torch.device("cpu")


def _batch(seed, b=5, n_lo=10, n_hi=28, pad=32):
    adj, mask, ns, es = graphs.er_batch(np.random.default_rng(seed), b,
                                        n_lo, n_hi, pad, 4.0)
    return torch.from_numpy(adj), torch.from_numpy(mask)


def test_rounding_matches_the_casts():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0)) * 7
    # exact ties of bfloat16 (a set bit 16 and nothing below it)
    ties = (torch.arange(1, 65, dtype=torch.int32) << 16 | (1 << 15)).view(
        torch.float32)
    for t in (x, ties, -ties):
        assert torch.equal(precision.round_significand(t, 7),
                           t.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(precision.rounder("fp8_e4m3")(torch.tensor([1.0625,
                                                                   1.1875])),
                       torch.tensor([1.0, 1.25]))


def test_draws_are_the_programs():
    m = _batch(1)[1].to(torch.float32)
    got = ref_traffic.Draws(0.9, 0.0, 100.0, CPU)(
        torch.Generator().manual_seed(77), m)
    want = _traffic(0.9, 0.0, 100.0)(torch.Generator().manual_seed(77), m)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["random", "ties", "signed_zero"])
def test_lgs_dense_equals_the_programs(kind):
    adj, mask = _batch(2)
    gen = torch.Generator().manual_seed(3)
    w = torch.rand(mask.shape, generator=gen)
    if kind == "ties":
        w = torch.floor(w * 3)
    if kind == "signed_zero":
        w = torch.where(w < 0.5, torch.zeros_like(w), w)
        w = torch.where(torch.rand(w.shape, generator=gen) < 0.5, -w, w)
    want = batched_lgs_plain(adj, w, mask)[0]
    assert torch.equal(lgs.lgs_dense(adj > 0, w, mask), want)


def test_lgs_ell_equals_the_programs():
    adj = graphs.geometric(np.random.default_rng(4), 1024, 10.0)
    g = build_large_graph(adj, block_size=512, use_bsr=False, device=CPU)
    rg = large.graph(adj, CPU)
    w = torch.floor(torch.rand(1024, generator=torch.Generator()
                               .manual_seed(5)) * 20)
    want = ell_lgs(g.ell_cols, g.ell_valid, w, g.mask)[0]
    assert torch.equal(lgs.lgs_ell(rg.nbr, rg.valid, w, rg.mask), want)


@pytest.mark.parametrize("mode", ["dqn", "gdpg"])
def test_dense_episode_is_the_programs_bit_for_bit(mode):
    adj, mask = _batch(6)
    flags = Config(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                   max_degree=1, predict="mwis", compute_dtype="float32")
    model = make_model_from_config(flags, "gcn2_dqn", params=params_from_jax(
        load_params(tiny.CKPT)), device=CPU)
    run = make_closed_loop(model, flags, timeslots=15, load=0.9,
                           feature_mode=mode)
    q, met = run(adj, mask, torch.zeros(mask.shape),
                 torch.Generator().manual_seed(9))
    layers = checkpoint.load_layers(tiny.CKPT, CPU)
    rq, rmet = dense.episode(layers, adj, mask,
                             torch.Generator().manual_seed(9), 15,
                             ref_traffic.Draws(0.9, 0.0, 100.0, CPU), mode)
    assert torch.equal(q, rq)
    for key in rmet:
        assert torch.equal(met[key], rmet[key])


def _large(weighted):
    rng = np.random.default_rng(8)
    adj = graphs.geometric(rng, 1024, 12.0)
    if weighted:
        adj = graphs.weighted_copy(rng, adj, 0.5, 1.5)
    return adj


@pytest.mark.parametrize("weighted", [False, True])
def test_large_slot_is_the_programs(weighted):
    adj = _large(weighted)
    g = build_large_graph(adj, block_size=512, use_bsr=True, device=CPU)
    plist = params_to_list(load_params(tiny.CKPT), device=CPU)
    step = make_large_closed_loop(g, timeslots=1, load=0.9,
                                  feature_mode="dqn")
    rg = large.graph(adj, CPU)
    layers = checkpoint.load_layers(tiny.CKPT, CPU)
    fwd = (lambda x: large.forward_exact(rg, layers, x, lambda t: t)) \
        if weighted else \
        (lambda x: large.forward_fused(rg, layers, x,
                                       precision.rounder("bfloat16")))
    draws = ref_traffic.Draws(0.9, 0.0, 100.0, CPU)
    gen, rgen = (torch.Generator().manual_seed(10) for _ in range(2))
    q = torch.zeros(1024)
    for _ in range(4):
        q_new, met = step(plist, q, gen)
        arrivals, rates = draws(rgen, torch.ones(1024))
        rq, util, _, _ = large.slot(rg, fwd, q, arrivals, rates)
        assert int((rq != q_new).sum()) <= 2
        assert float(met["avg_utility"]) == pytest.approx(float(util),
                                                          rel=1e-3)
        q = q_new


def test_large_forwards_follow_the_programs_routes():
    adj = _large(True)
    g = build_large_graph(adj, block_size=512, use_bsr=True, device=CPU)
    plist = params_to_list(load_params(tiny.CKPT), device=CPU)
    rg = large.graph(adj, CPU)
    layers = checkpoint.load_layers(tiny.CKPT, CPU)
    x = (torch.rand(1024, 1, generator=torch.Generator().manual_seed(11))
         > 0.1).to(torch.float32)
    want = large_gcn_forward(g, plist, x, fused=False)
    got = large.forward_exact(rg, layers, x, lambda t: t)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    g01 = build_large_graph(sp.csr_matrix((adj > 0).astype(np.float32)),
                            block_size=512, use_bsr=True, device=CPU)
    rg01 = large.graph((adj > 0).astype(np.float32), CPU)
    want = large_gcn_forward(g01, plist, x)
    got = large.forward_fused(rg01, layers, x, precision.rounder("bfloat16"))
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-3)
