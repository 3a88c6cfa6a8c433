"""Port parity: the batched train pipeline and on-device online training.

- `make_train_pipeline` against JAX's with the same `rand` and `explore`:
  selections bit-equal, util and gutil within rtol 1e-6, acts within
  rtol 1e-5 (the f32 GCN forward agrees to ~1e-6 relative).
- `make_online_train_step` against a JAX step assembled here from the JAX
  package's own functions (`slot_utilities`, `build_features`,
  `batched_lgs`, the loop's loss, `tf1_adam`), three chained slots on the
  same arrivals and rates: losses, rewards and queues (drained on the
  selected nodes) within rtol 1e-5, parameters within 2·lr·steps + rtol 1e-5
  (see tests/test_torch_agents.py for that bound).
- An online episode (draws from a `torch.Generator`, so held to the JAX
  test's bands, not draw for draw).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import random_graph
from distgcn_tpu import pipeline as jpipe
from distgcn_tpu.agents import DQNAgent as JDQNAgent
from distgcn_tpu.agents import build_features as jbuild_features
from distgcn_tpu.core import prep as jprep
from distgcn_tpu.core.graph import GraphBatch as JGraphBatch
from distgcn_tpu.models.gcn import make_model_from_config as jax_model
from distgcn_tpu.ops.lgs import batched_lgs as jbatched_lgs
from distgcn_tpu.rl.train import make_optimizer as jmake_optimizer
from distgcn_tpu.sim import device_sim as jsim
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu.utils.serialization import load_params as jload_params
from distgcn_tpu_torch import pipeline
from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.rl.train import make_optimizer
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.utils.config import Config

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "model", "result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_"
    "mwis_dqn", "params.npz")
LR = 1e-3


def _batch(rng, b=6, lo=20, hi=60, pad=64):
    adjs, wtss = [], []
    for _ in range(b):
        n = int(rng.integers(lo, hi))
        adjs.append(random_graph(rng, n, 0.1))
        wtss.append(rng.random(n))
    return (JGraphBatch.from_scipy(adjs, wtss, pad_to=pad),
            GraphBatch.from_scipy(adjs, wtss, pad_to=pad, device="cpu"))


def _models(source, **kw):
    """(JAX model, JAX params, port model, JAX cfg, port cfg)."""
    if source == "ckpt":
        cfg = dict(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                   max_degree=1, predict="mwis", pad_to=64, **kw)
        family, params = "gcn2_dqn", jload_params(CKPT)
    else:
        cfg = dict(dict(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
                        max_degree=1, predict="mwis", epsilon=0.0,
                        pad_to=64), **kw)
        family = "gcn_dqn"
        params = JDQNAgent(JConfig(**cfg), model_family=family).params
    jcfg, tcfg = JConfig(**cfg), Config(**cfg)
    tmodel = make_model_from_config(tcfg, family,
                                    params=params_from_jax(params),
                                    device="cpu")
    return jax_model(jcfg, family), params, tmodel, jcfg, tcfg


def _independent_and_maximal(sel, adj, mask):
    on = sel == 1
    a = adj > 0
    independent = not np.any(a & on[:, :, None] & on[:, None, :])
    covered = on | np.any(a & on[:, None, :], axis=-1)
    return independent and bool(np.all(covered[mask]))


@pytest.mark.parametrize("source", ["init", "ckpt"])
@pytest.mark.parametrize("feature_mode", ["gdpg", "dqn"])
def test_train_pipeline_matches_jax(rng, source, feature_mode):
    jmodel, jparams, tmodel, jcfg, tcfg = _models(source)
    jb, tb = _batch(rng)
    b, n = tb.wts.shape
    rand = rng.random((b, n)).astype(np.float32)
    explore = np.array([True, False, True, False, False, True])
    jsel, jutil, jgutil, jacts = jpipe.make_train_pipeline(
        jmodel, jcfg, feature_mode)(jparams, jb.adj, jb.wts, jb.mask,
                                    jnp.asarray(rand), jnp.asarray(explore))
    sel, util, gutil, acts = pipeline.make_train_pipeline(
        tmodel, tcfg, feature_mode)(tb.adj, tb.wts, tb.mask,
                                    torch.from_numpy(rand),
                                    torch.from_numpy(explore))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(util.numpy(), np.asarray(jutil), rtol=1e-6)
    np.testing.assert_allclose(gutil.numpy(), np.asarray(jgutil), rtol=1e-6)
    np.testing.assert_allclose(acts.numpy(), np.asarray(jacts), rtol=1e-5,
                               atol=1e-7)
    mask = tb.mask.numpy()
    # head 0 is the uniform draw on explored graphs, exactly
    np.testing.assert_array_equal(acts.numpy()[explore, :, 0],
                                  (rand * mask)[explore])
    assert _independent_and_maximal(sel.numpy(), tb.adj.numpy(), mask)


def test_train_pipeline_bfloat16_scores_a_copy_and_stays_valid(rng):
    _, _, tmodel, _, tcfg = _models("ckpt", compute_dtype="bfloat16")
    _, tb = _batch(rng)
    b, n = tb.wts.shape
    rand = torch.from_numpy(rng.random((b, n)).astype(np.float32))
    explore = torch.zeros(b, dtype=torch.bool)
    sel, util, gutil, acts = pipeline.make_train_pipeline(tmodel, tcfg)(
        tb.adj, tb.wts, tb.mask, rand, explore)
    assert next(tmodel.parameters()).dtype == torch.float32
    assert acts.dtype == util.dtype == torch.float32
    assert _independent_and_maximal(sel.numpy(), tb.adj.numpy(),
                                    tb.mask.numpy())
    f32 = pipeline.make_train_pipeline(tmodel, tcfg.replace(
        compute_dtype="float32"))(tb.adj, tb.wts, tb.mask, rand, explore)
    ratio = float(util.sum() / gutil.sum())
    ratio32 = float(f32[1].sum() / f32[2].sum())
    assert abs(ratio - ratio32) <= 0.01 * ratio32


def _jax_online_step(model, cfg, opt, feature_mode="gdpg"):
    """The body of the JAX package's `make_online_training_loop`
    (sim/device_sim.py:342-383) with arrivals and rates as inputs."""
    wd = cfg.weight_decay

    @jax.jit
    def step(params, opt_state, supports, adjb, mask, queue, arrivals,
             rates):
        m = mask.astype(queue.dtype)
        queue = queue + arrivals
        wts = jsim.slot_utilities(queue, rates, "qr") * m
        feats = jbuild_features(wts, mask, cfg.feature_size, cfg.predict,
                                feature_mode)
        out = model.apply({"params": params}, feats, supports)
        act = out[..., 0].astype(wts.dtype) * mask
        sel, util, _ = jbatched_lgs(adjb, act * wts, mask)
        _, gutil, _ = jbatched_lgs(adjb, wts, mask)
        reward = util / jnp.maximum(gutil, 1e-9)
        on = sel == 1
        labels = jnp.where(on, reward[:, None], act)

        def loss_fn(p):
            o = model.apply({"params": p}, feats, supports)
            err = (o[..., 0] - labels) ** 2 * m
            mse = jnp.sum(err, axis=-1) / jnp.maximum(jnp.sum(m, axis=-1),
                                                      1.0)
            l2 = sum(jnp.sum(v ** 2) / 2.0
                     for v in jax.tree_util.tree_leaves(p["gc1"]))
            return jnp.mean(jnp.sqrt(mse)) + wd * l2

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        queue = queue - jnp.minimum(queue, rates * on.astype(queue.dtype))
        return params, opt_state, queue, loss, jnp.mean(reward)

    return step


@pytest.mark.parametrize("feature_mode", ["gdpg", "dqn"])
def test_online_train_step_matches_a_jax_step(rng, feature_mode):
    jmodel, jparams, tmodel, jcfg, tcfg = _models("init")
    jb, tb = _batch(rng, b=4, lo=20, hi=40, pad=48)
    jsup = jprep.masked_simple_polynomials_dense(jb.adj, jb.mask, 1)
    tsup = prep.masked_simple_polynomials_dense(tb.adj, tb.mask, 1)
    jopt, topt = jmake_optimizer(LR), make_optimizer(LR)
    jstep = _jax_online_step(jmodel, jcfg, jopt, feature_mode)
    tstep = device_sim.make_online_train_step(tmodel, tcfg, topt,
                                              feature_mode=feature_mode)
    params = dict(tmodel.named_parameters())
    jstate, tstate = jopt.init(jparams), topt.init(params)
    mask = tb.mask.numpy()
    queue = (rng.random(mask.shape) * 50).astype(np.float32) * mask
    jq, tq = jnp.asarray(queue), torch.from_numpy(queue)
    steps = 3
    for _ in range(steps):
        arrivals = rng.poisson(10.0, mask.shape).astype(np.float32) * mask
        rates = np.clip(np.trunc(rng.normal(50, 25, mask.shape)), 0,
                        100).astype(np.float32) * mask
        jparams, jstate, jq, jloss, jratio = jstep(
            jparams, jstate, jsup, jb.adj > 0, jb.mask, jq,
            jnp.asarray(arrivals), jnp.asarray(rates))
        tstate, tq, slot = tstep(tstate, tsup, tb.adj > 0, tb.mask, tq,
                                 torch.from_numpy(arrivals),
                                 torch.from_numpy(rates))
        np.testing.assert_allclose(float(slot["loss"]), float(jloss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(slot["ratio"]), float(jratio),
                                   rtol=1e-5)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5)
        np.testing.assert_allclose(slot["queue_sum"].numpy(),
                                   np.asarray(jq).sum(-1), rtol=1e-5)
    assert tstate["count"] == int(jstate["count"]) == steps
    for layer, leaves in jparams.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(params[f"{layer}.{k}"].detach(),
                                       np.asarray(v), rtol=1e-5,
                                       atol=2 * LR * steps)


def test_online_episode_trains_with_finite_losses_and_queues(rng):
    _, _, tmodel, _, tcfg = _models("init", pad_to=32)
    adjs = [random_graph(rng, n=30, p=0.1) for _ in range(4)]
    tb = GraphBatch.from_scipy(adjs, [np.ones(30)] * 4, pad_to=32,
                               device="cpu")
    opt = make_optimizer(1e-3)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    run = device_sim.make_online_training_loop(tmodel, tcfg, opt,
                                               timeslots=60, load=0.6)
    state = opt.init(dict(tmodel.named_parameters()))
    state, qT, m = run(state, tb.adj, tb.mask, torch.zeros((4, 32)),
                       torch.Generator().manual_seed(0))
    losses = m["loss"].numpy()
    ratios = m["avg_utility_ratio"].numpy()
    assert state["count"] == 60
    assert np.all(np.isfinite(losses)) and np.all(np.isfinite(ratios))
    assert np.all(ratios > 0.2)
    assert losses[-10:].mean() < losses[:10].mean()
    assert bool(torch.isfinite(qT).all()) and bool((qT >= 0).all())
    assert bool((qT[~tb.mask] == 0).all())
    assert m["avg_queue_len"].shape == (4,)
    assert any(not torch.equal(v, before[k])
               for k, v in tmodel.state_dict().items())
    with pytest.raises(ValueError, match="generator"):
        run(state, tb.adj, tb.mask, torch.zeros((4, 32), device="meta"),
            torch.Generator())


def test_online_reward_is_the_gcn_weighted_ratio_in_both_packages(rng):
    """The JAX loop's reward is sum(act*w)[sel] / sum_greedy(w): `util`
    comes back from `batched_lgs` under the GCN weights it was given. Its
    docstring promises the raw scheduled-utility / greedy ratio. The port
    reproduces the JAX package; ROADMAP §C records the fault."""
    jmodel, jparams, tmodel, jcfg, tcfg = _models("init")
    jb, tb = _batch(rng, b=4, lo=20, hi=40, pad=48)
    jopt = jmake_optimizer(LR)
    run = jsim.make_online_training_loop(jmodel, jcfg, jopt, timeslots=1,
                                         load=0.6)
    key = jax.random.PRNGKey(0)
    q0 = jnp.zeros(jb.wts.shape)
    _, _, _, metrics = run(jparams, jopt.init(jparams), jb.adj, jb.mask,
                           q0, key)
    # slot 1's inputs, drawn as the loop draws them
    _, ka, kr = jax.random.split(key, 3)
    m = jb.mask.astype(jnp.float32)
    arrivals = jsim.make_poisson_arrivals(30.0)(ka, q0.shape) * m
    rates = jnp.clip(jnp.trunc(jax.random.normal(kr, q0.shape) * 25.0
                               + 50.0), 0.0, 100.0) * m
    wts = (q0 + arrivals) * rates * m
    sup = jprep.masked_simple_polynomials_dense(jb.adj, jb.mask, 1)
    feats = jbuild_features(wts, jb.mask, 1)
    act = jmodel.apply({"params": jparams}, feats, sup)[..., 0] * jb.mask
    sel, util, _ = jbatched_lgs(jb.adj > 0, act * wts, jb.mask)
    _, gutil, _ = jbatched_lgs(jb.adj > 0, wts, jb.mask)
    raw = jnp.sum(jnp.where(sel == 1, wts, 0.0), -1)
    actual = float(jnp.mean(util / gutil))
    promised = float(jnp.mean(raw / gutil))
    np.testing.assert_allclose(float(metrics["avg_utility_ratio"][0]),
                               actual, rtol=1e-6)
    assert abs(actual - promised) > 0.1 * promised
    # the port's step gives the same reward on the same inputs
    topt = make_optimizer(LR)
    step = device_sim.make_online_train_step(tmodel, tcfg, topt)
    _, _, slot = step(topt.init(dict(tmodel.named_parameters())),
                      prep.masked_simple_polynomials_dense(tb.adj, tb.mask,
                                                           1),
                      tb.adj > 0, tb.mask, torch.zeros(tuple(q0.shape)),
                      torch.from_numpy(np.array(arrivals)),
                      torch.from_numpy(np.array(rates)))
    np.testing.assert_allclose(float(slot["ratio"]), actual, rtol=1e-5)
