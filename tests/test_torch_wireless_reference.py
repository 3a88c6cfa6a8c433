"""The port's wireless device loops (`sim/device_sim.make_closed_loop`
with the greedy baseline, `make_closed_loop_seq`) against the benchmark's
plain reference (`bench_h100/reference/wireless.py`) on the CPU, with the
same generator seeds: seeded random weights with random biases at a small
size, and the published checkpoint (ERGDPG2 l20 c32) on four of the
repository's networks as `cli.wireless_sim.pack_networks` packs them.

Both sides draw the same arrivals and rates and run the same float32
products in the same order, so queues and metrics are compared bit for
bit. Every case sees links whose utility is 0 (a rate of 0, an empty
queue, or a drain estimate that emptied a link on an earlier channel):
the sequential loop deletes them from each channel's subgraph before the
GCN scores it, which the reference does on its own.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from bench_h100.reference import checkpoint, traffic, wireless
from distgcn_tpu_torch.cli import wireless_sim
from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.serialization import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "model",
                    "result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn",
                    "params.npz")
SMALL = dict(feature_size=1, hidden1=8, num_layer=3, diver_num=1,
             max_degree=1, predict="mwis")


def _batch(seed, b=3, nfp=24, n_ch=3, p=0.25):
    """Per-channel 0/1 graphs [B, n_ch, nfp, nfp] float32 with ragged link
    counts, and the link mask [B, nfp]."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((b, n_ch, nfp, nfp), np.float32)
    mask = np.zeros((b, nfp), bool)
    for i in range(b):
        n = nfp - 4 * i
        for c in range(n_ch):
            a = np.triu(rng.random((n, n)) < p, 1)
            adj[i, c, :n, :n] = a | a.T
        mask[i, :n] = True
    return torch.from_numpy(adj), torch.from_numpy(mask)


def _small_model(seed=5):
    """A gcn2_dqn ChebGCN (leaky ReLU on every layer, biases) with seeded
    random weights and nonzero biases, and its layers as the reference
    reads them."""
    flags = Config(**SMALL, compute_dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    model = make_model_from_config(flags, "gcn2_dqn", generator=gen,
                                   device="cpu")
    with torch.no_grad():
        for i in range(model.num_layer):
            layer = getattr(model, f"gc{i + 1}")
            layer.bias.copy_(torch.rand(layer.bias.shape, generator=gen)
                             - 0.5)
    return model, flags, _layers(model)


def _layers(model):
    return [{k: getattr(model, f"gc{i + 1}").get_parameter(k).detach()
             for k in ("w_0", "w_1", "bias")}
            for i in range(model.num_layer)]


def _lgs_masks(monkeypatch):
    """Record the mask of every LGS call of the device loops."""
    seen = []
    lgs = device_sim.batched_lgs

    def recording(adjb, w, mask, *a):
        seen.append(mask.clone())
        return lgs(adjb, w, mask, *a)
    monkeypatch.setattr(device_sim, "batched_lgs", recording)
    return seen


def _same(got, want):
    (q, met), (rq, rmet) = got, want
    assert torch.equal(q, rq)
    assert set(met) == set(rmet)
    for k in rmet:
        assert torch.equal(met[k], rmet[k]), k


def _single(model, flags, layers, adj, mask, load, seed, t=30):
    run = device_sim.make_closed_loop(model, flags, timeslots=t, load=load,
                                      feature_mode="gdpg",
                                      with_baseline=True)
    got = run(adj, mask, torch.zeros(mask.shape),
              torch.Generator().manual_seed(seed))
    want = wireless.episode_single(
        layers, adj, mask, torch.Generator().manual_seed(seed), t,
        traffic.Draws(load, 0.0, 100.0, "cpu"))
    return got, want


def _seq(model, flags, layers, adj_ch, mask, load, seed, use_gcn=True,
         t=30):
    run = device_sim.make_closed_loop_seq(model, flags, timeslots=t,
                                          n_ch=adj_ch.shape[1], load=load,
                                          use_gcn=use_gcn)
    got = run(adj_ch, mask, torch.zeros(mask.shape),
              torch.Generator().manual_seed(seed))
    want = wireless.episode_seq(
        layers, adj_ch, mask, torch.Generator().manual_seed(seed), t,
        wireless.ChannelDraws(load, 0.0, 100.0, adj_ch.shape[1], "cpu"),
        use_gcn=use_gcn)
    return got, want


@pytest.mark.parametrize("load", [0.2, 0.9])
def test_single_channel_loop_with_baseline_matches_the_reference(load):
    model, flags, layers = _small_model()
    adj_ch, mask = _batch(21)
    got, want = _single(model, flags, layers, adj_ch[:, 0].contiguous(),
                        mask, load, seed=1000 + int(load * 10))
    _same(got, want)
    assert "avg_utility_ratio" in got[1]


@pytest.mark.parametrize("use_gcn,load", [(True, 0.2), (True, 1.2),
                                          (False, 0.6)])
def test_sequential_loop_matches_the_reference(monkeypatch, use_gcn, load):
    """Loads 0.2 and 0.6 leave many links empty after a channel drains
    them; at every load some channel call deletes real links."""
    model, flags, layers = _small_model()
    adj_ch, mask = _batch(22)
    masks = _lgs_masks(monkeypatch)
    got, want = _seq(model, flags, layers, adj_ch, mask, load,
                     seed=2000 + int(load * 10), use_gcn=use_gcn)
    _same(got, want)
    deleted = sum(int((mask & ~m).sum()) for m in masks)
    assert len(masks) == 3 * 30 and deleted > 0


def test_sequential_loop_scores_the_subgraph_not_the_channel_graph():
    """Scoring a channel on its whole graph (the JAX package's loop, ROADMAP
    §C fault 8) gives other GCN weights than the subgraph of the
    positive-utility links, the reference's: the same loop with the
    whole-graph supports leaves the reference."""
    model, flags, layers = _small_model()
    adj_ch, mask = _batch(23)
    got, want = _seq(model, flags, layers, adj_ch, mask, 0.2, seed=7)
    _same(got, want)
    real = device_sim.subgraph_supports
    try:
        device_sim.subgraph_supports = (
            lambda adj, keep, k, dtype: real(adj, torch.ones_like(keep), k,
                                             dtype))
        whole, _ = _seq(model, flags, layers, adj_ch, mask, 0.2, seed=7)
    finally:
        device_sim.subgraph_supports = real
    assert not torch.equal(whole[0], want[0])


@pytest.fixture(scope="module")
def published():
    flags = Config(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                   max_degree=1, predict="mwis", compute_dtype="float32")
    model = make_model_from_config(flags, "gcn2_dqn", params=params_from_jax(
        load_params(CKPT)), device="cpu")
    return model, flags, checkpoint.load_layers(CKPT, "cpu")


def _networks(n_ch):
    cfg = Config(test_datapath=os.path.join(REPO, "data", "wireless_test"),
                 num_channels=n_ch)
    nets, adj, mask, adj_ch = wireless_sim.pack_networks(cfg, 4)
    assert len(nets) == 4 and mask.shape == (4, 128)
    return torch.from_numpy(adj), torch.from_numpy(mask), \
        torch.from_numpy(adj_ch)


def test_published_checkpoint_on_repo_networks_single_channel(published):
    model, flags, layers = published
    adj, mask, _ = _networks(1)
    got, want = _single(model, flags, layers, adj, mask, 0.9, seed=31, t=20)
    _same(got, want)


@pytest.mark.parametrize("load", [0.6, 1.2])
def test_published_checkpoint_on_repo_networks_sequential(monkeypatch,
                                                          published, load):
    model, flags, layers = published
    _, mask, adj_ch = _networks(3)
    masks = _lgs_masks(monkeypatch)
    got, want = _seq(model, flags, layers, adj_ch, mask, load,
                     seed=41 + int(load * 10), t=12)
    _same(got, want)
    assert sum(int((mask & ~m).sum()) for m in masks) > 0
