"""Port parity: the closed-loop slot scheduler against JAX.

`make_slot_step` is deterministic given queue, arrivals and rates, and is
held exactly to the JAX step (schedules bit-equal, queues and utilities to
f32 rounding). Episodes draw from a `torch.Generator`, whose streams cannot
match `jax.random`'s, so whole episodes are held to the JAX tests' bands
(tests/test_device_sim.py) and the arrival sampler to scipy's quantiles.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_graph
from distgcn_tpu.core import prep as jprep
from distgcn_tpu.core.graph import GraphBatch as JGraphBatch
from distgcn_tpu.agents import DQNAgent
from distgcn_tpu.sim import device_sim as jsim
from distgcn_tpu.sim.wireless import slot_weights
from distgcn_tpu.solvers.greedy import local_greedy_search
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.utils.config import Config

CFG = dict(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
           max_degree=1, predict="mwis", epsilon=0.0)


def _batch(rng, b=3, n=40, pad=48):
    adjs = [random_graph(rng, n=n, p=0.1) for _ in range(b)]
    wtss = [np.ones(n) for _ in range(b)]
    return (JGraphBatch.from_scipy(adjs, wtss, pad_to=pad),
            GraphBatch.from_scipy(adjs, wtss, pad_to=pad, device="cpu"),
            adjs)


def _models(pad, num_layer=2, **kw):
    """(JAX model, JAX params, port model, JAX cfg, port cfg): the JAX
    tests' agent (tests/test_device_sim.py:_agent) and its port."""
    cfg_kw = dict(CFG, num_layer=num_layer, pad_to=pad, **kw)
    jcfg, cfg = JConfig(**cfg_kw), Config(**cfg_kw)
    agent = DQNAgent(jcfg, model_family="gcn_dqn")
    tmodel = make_model_from_config(cfg, "gcn_dqn",
                                    params=params_from_jax(agent.params),
                                    device="cpu")
    return agent.model, agent.params, tmodel, jcfg, cfg


def _traffic(rng, mask, zero_frac=0.0):
    b, n = mask.shape
    queue = (rng.random((b, n)) * 50).astype(np.float32) * mask
    queue[rng.random((b, n)) < zero_frac] = 0.0
    arrivals = (rng.random((b, n)) * 10).astype(np.float32) * mask
    arrivals[rng.random((b, n)) < zero_frac] = 0.0
    rates = np.trunc(rng.random((b, n)) * 100).astype(np.float32) * mask
    return queue, arrivals, rates


@pytest.mark.parametrize("use_gcn,feature_mode,num_layer", [
    (False, "gdpg", 2), (True, "gdpg", 2), (True, "dqn", 2),
    (True, "gdpg", 20)])
def test_slot_step_matches_jax(rng, use_gcn, feature_mode, num_layer):
    jb, tb, adjs = _batch(rng)
    jmodel, params, tmodel, jcfg, cfg = _models(48, num_layer)
    mask = tb.mask.numpy()
    queue, arrivals, rates = _traffic(rng, mask, zero_frac=0.3)
    jsup = jprep.masked_simple_polynomials_dense(jb.adj, jb.mask, 1)
    tsup = prep.masked_simple_polynomials_dense(tb.adj, tb.mask, 1)
    jstep = jsim.make_slot_step(jmodel, jcfg, feature_mode, use_gcn=use_gcn)
    tstep = device_sim.make_slot_step(tmodel, cfg, feature_mode,
                                      use_gcn=use_gcn)
    want = jstep(params, jsup, jb.adj > 0, jb.mask, jnp.asarray(queue),
                 jnp.asarray(arrivals), jnp.asarray(rates))
    got = tstep(tsup, tb.adj > 0, tb.mask, torch.from_numpy(queue),
                torch.from_numpy(arrivals), torch.from_numpy(rates))
    q2, sel, util, wts = (x.numpy() for x in got)
    np.testing.assert_array_equal(sel, np.asarray(want[1]))
    np.testing.assert_array_equal(q2, np.asarray(want[0]))
    np.testing.assert_array_equal(wts, np.asarray(want[3]))
    np.testing.assert_allclose(util, np.asarray(want[2]), rtol=1e-6)
    if not use_gcn:
        # and the host simulator's math (tests/test_device_sim.py:31)
        for i, a in enumerate(adjs):
            nn = a.shape[0]
            q = queue[i, :nn] + arrivals[i, :nn]
            w_host = slot_weights(q, rates[i, :nn, None], "qr")[:, 0]
            mwis, total = local_greedy_search(a, w_host)
            assert set(np.flatnonzero(sel[i, :nn] == 1)) == mwis


@pytest.mark.parametrize("wt_sel", ["qr", "q", "qor", "qrm"])
def test_slot_utilities_match_jax(rng, wt_sel):
    q = (rng.random((2, 7)) * 10).astype(np.float32)
    r = np.trunc(rng.random((2, 7)) * 100).astype(np.float32)
    r[0, :2] = 0.0
    got = device_sim.slot_utilities(torch.from_numpy(q), torch.from_numpy(r),
                                    wt_sel)
    want = jsim.slot_utilities(jnp.asarray(q), jnp.asarray(r), wt_sel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slot_utilities_random_needs_generator():
    q = torch.ones((2, 5))
    with pytest.raises(ValueError):
        device_sim.slot_utilities(q, q, "random")
    u = device_sim.slot_utilities(q, q, "random",
                                  generator=torch.Generator().manual_seed(0))
    assert u.shape == q.shape and bool(((u >= 0) & (u < 1)).all())


def _episode(run, tb, seed):
    b, n = tb.wts.shape
    return run(tb.adj, tb.mask, torch.zeros((b, n)),
               torch.Generator().manual_seed(seed))


def test_closed_loop_runs_and_queues_are_stable(rng):
    _, tb, _ = _batch(rng, b=4, n=30, pad=32)
    _, _, tmodel, _, cfg = _models(32)
    run = device_sim.make_closed_loop(tmodel, cfg, timeslots=50, load=0.5,
                                      with_baseline=True)
    # the JAX test's band holds for most draws, not all, in both packages:
    # on these graphs and params JAX's PRNGKey(2) gives a 0.783 ratio
    qT, metrics = _episode(run, tb, 1)
    qT = qT.numpy()
    assert qT.shape == tuple(tb.wts.shape)
    assert np.all(qT >= 0) and np.all(np.isfinite(qT))
    assert np.all(metrics["avg_queue_len"].numpy() >= 0)
    assert np.all(metrics["avg_utility"].numpy() >= 0)
    assert np.all(metrics["avg_utility_ratio"].numpy() > 0.8)
    assert np.all(qT[~tb.mask.numpy()] == 0)   # masked arrivals


def test_closed_loop_low_load_drains_queues(rng):
    _, tb, _ = _batch(rng, b=2, n=20, pad=24)
    _, _, tmodel, _, cfg = _models(24)
    lens = {}
    for load in (0.02, 2.0):
        run = device_sim.make_closed_loop(tmodel, cfg, timeslots=100,
                                          load=load, use_gcn=False)
        _, metrics = _episode(run, tb, 1)
        lens[load] = float(metrics["avg_queue_len"].mean())
    assert lens[0.02] < lens[2.0]              # overload builds backlog


def test_closed_loop_bfloat16_matches_f32_quality(rng):
    _, tb, _ = _batch(rng, b=4, n=30, pad=32)
    outs = {}
    for dt in ("float32", "bfloat16"):
        _, _, tmodel, _, cfg = _models(32, compute_dtype=dt)
        run = device_sim.make_closed_loop(tmodel, cfg, timeslots=50,
                                          load=0.5, with_baseline=True)
        qT, metrics = _episode(run, tb, 0)
        assert bool((qT >= 0).all())
        assert next(tmodel.parameters()).dtype == torch.float32
        outs[dt] = float(metrics["avg_utility_ratio"].mean())
    assert abs(outs["bfloat16"] - outs["float32"]) < 0.02, outs


@pytest.mark.parametrize("wt_sel", ["qr", "qrm"])
def test_gdpg_hoist_matches_per_slot_gcn(rng, wt_sel):
    """The hoisted episode (scores once per episode) equals an episode that
    runs the GCN every slot on the same draws, slot by slot."""
    _, tb, _ = _batch(rng, b=3, n=30, pad=32)
    _, _, tmodel, _, cfg = _models(32, num_layer=3)
    timeslots, load, rate_hi = 20, 0.9, 100.0
    run = device_sim.make_closed_loop(tmodel, cfg, timeslots, load=load,
                                      wt_sel=wt_sel, feature_mode="gdpg")
    qT, metrics = _episode(run, tb, 5)

    step = device_sim.make_slot_step(tmodel, cfg, "gdpg", wt_sel)
    sup = prep.masked_simple_polynomials_dense(tb.adj, tb.mask, 1)
    draw = device_sim.make_poisson_arrivals(0.5 * rate_hi * load)
    gen = torch.Generator().manual_seed(5)
    m = tb.mask.float()
    queue = torch.zeros_like(m)
    utils = []
    for _ in range(timeslots):
        arrivals = draw(gen, queue.shape) * m
        rates = torch.randn(queue.shape, generator=gen) * 25.0 + 50.0
        rates = torch.clamp(torch.trunc(rates), 0.0, rate_hi) * m
        queue, sel, util, _ = step(sup, tb.adj > 0, tb.mask, queue,
                                   arrivals, rates)
        utils.append(util)
    assert torch.equal(qT, queue)
    assert torch.equal(metrics["avg_utility"],
                       torch.stack(utils).mean(dim=0))


def test_dqn_mode_runs_gcn_every_slot(rng):
    _, tb, _ = _batch(rng, b=2, n=30, pad=32)
    _, _, tmodel, _, cfg = _models(32)
    calls = []
    handle = tmodel.register_forward_hook(lambda *a: calls.append(1))
    try:
        for mode, want in (("gdpg", 1), ("dqn", 7)):
            calls.clear()
            run = device_sim.make_closed_loop(tmodel, cfg, timeslots=7,
                                              feature_mode=mode)
            _episode(run, tb, 0)
            assert len(calls) == want, mode
    finally:
        handle.remove()


def test_poisson_arrivals_match_scipy_quantiles():
    """Inverse-CDF arrivals == scipy.stats.poisson.ppf at every bin
    midpoint, the cdf table equals the JAX package's, and samples from a
    torch.Generator have Poisson moments."""
    from scipy import stats
    for lam in (1.0, 7.5, 45.0):
        cdf = device_sim._poisson_cdf(lam)
        np.testing.assert_array_equal(cdf, jsim._poisson_cdf(lam))
        cdf64 = stats.poisson.cdf(np.arange(0, int(8 * lam + 32)), lam)
        keep = np.diff(cdf64) > 1e-5
        mids = ((cdf64[:-1] + cdf64[1:]) / 2)[keep]
        cdf32 = torch.from_numpy(cdf.astype(np.float32))
        got = torch.searchsorted(cdf32, torch.from_numpy(
            mids.astype(np.float32)))
        np.testing.assert_array_equal(got.numpy(), stats.poisson.ppf(mids,
                                                                     lam))
        s = device_sim.make_poisson_arrivals(lam)(
            torch.Generator().manual_seed(3), (40000,)).numpy()
        assert abs(s.mean() - lam) < 0.15 * np.sqrt(lam)
        assert abs(s.var() - lam) < 0.2 * lam


def test_poisson_arrivals_count_strictly_less_entries():
    """#{k : u > cdf[k]}: a uniform equal to a table entry does not count
    it (the JAX lookup's strict comparison)."""
    lam = 7.5
    cdf = torch.from_numpy(device_sim._poisson_cdf(lam).astype(np.float32))
    u = torch.cat([cdf[:20], cdf[:20] + 1e-6, torch.tensor([0.0, 0.999])])
    got = torch.searchsorted(cdf, u)
    want = np.sum(np.asarray(u)[:, None] > np.asarray(cdf)[None, :], axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lam", [709.0, 800.0, 5000.0])
def test_poisson_cdf_rejects_large_rates(lam):
    with pytest.raises(ValueError, match="too large"):
        device_sim._poisson_cdf(lam)
    with pytest.raises(ValueError):
        device_sim.make_closed_loop(None, Config(), 10, load=1.0,
                                    rate_hi=2 * lam)


def test_closed_loop_rejects_generator_on_other_device(rng):
    _, tb, _ = _batch(rng, b=1, n=10, pad=16)
    _, _, tmodel, _, cfg = _models(16)
    run = device_sim.make_closed_loop(tmodel, cfg, timeslots=2)
    queue0 = torch.zeros(tuple(tb.wts.shape), device="meta")
    with pytest.raises(ValueError, match="generator"):
        run(tb.adj, tb.mask, queue0, torch.Generator())
