"""Port parity: the batched solve pipelines against JAX at 20 layers.

At f32 the schedule must be bit-equal to JAX's and the utilities allclose
(rtol 1e-5: the GCN forward agrees to ~1.5e-6, and LGS compares the
scores' order, not their values). bf16 mode is held to the JAX package's
own criterion: independent and maximal schedules, utility within 1% of
the f32 path.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_graph
from distgcn_tpu import pipeline as jpipe
from distgcn_tpu.core.graph import GraphBatch as JGraphBatch
from distgcn_tpu.core.prep import simple_polynomials_dense
from distgcn_tpu.models.gcn import make_model_from_config as jax_model
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu.utils.serialization import load_params as jload_params
from distgcn_tpu_torch import pipeline
from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.utils.config import Config

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "model", "result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_"
    "mwis_dqn", "params.npz")
CFG = dict(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
           max_degree=1, predict="mwis", pad_to=64)


def _instances(rng, k=6, lo=20, hi=60):
    out = []
    for _ in range(k):
        n = int(rng.integers(lo, hi))
        out.append((random_graph(rng, n, 0.1), rng.random(n)))
    return out


def _models(source, compute_dtype="float32", num_layer=20):
    """(JAX model, JAX params, port model) on the same parameters."""
    kw = dict(CFG, compute_dtype=compute_dtype, num_layer=num_layer)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    if source == "ckpt":
        family, params = "gcn2_dqn", jload_params(CKPT)
    else:
        family = "gcn_dqn"
        x = jnp.zeros((1, 64, 1))
        params = jax_model(jcfg, family).init(
            jax.random.PRNGKey(3), x, jnp.zeros((1, 2, 64, 64)))["params"]
    tmodel = make_model_from_config(cfg, family,
                                    params=params_from_jax(params),
                                    device="cpu")
    return jax_model(jcfg, family), params, tmodel, jcfg, cfg


def _batches(instances, pad=64):
    adjs = [a for a, _ in instances]
    wtss = [w for _, w in instances]
    return (JGraphBatch.from_scipy(adjs, wtss, pad_to=pad),
            GraphBatch.from_scipy(adjs, wtss, pad_to=pad, device="cpu"))


def _independent_and_maximal(sel, adj, mask):
    on = sel == 1
    a = adj > 0
    independent = not np.any(a & on[:, :, None] & on[:, None, :])
    covered = on | np.any(a & on[:, None, :], axis=-1)
    return independent and bool(np.all(covered[mask]))


@pytest.mark.parametrize("source", ["init", "ckpt"])
@pytest.mark.parametrize("feature_mode", ["gdpg", "dqn"])
@pytest.mark.parametrize("with_baseline", [True, False])
def test_solve_pipeline_matches_jax(rng, source, feature_mode,
                                    with_baseline):
    jmodel, jparams, tmodel, jcfg, cfg = _models(source)
    inst = _instances(rng)
    inst[0] = (inst[0][0], np.where(rng.random(inst[0][0].shape[0]) < 0.3,
                                    0.0, inst[0][1]))   # zeros: dqn features
    jb, tb = _batches(inst)
    jsolve = jpipe.make_solve_pipeline(jmodel, jcfg, feature_mode,
                                       with_baseline)
    tsolve = pipeline.make_solve_pipeline(tmodel, cfg, feature_mode,
                                          with_baseline)
    jsel, jutil, jgutil = jsolve(jparams, jb.adj, jb.wts, jb.mask)
    sel, util, gutil = tsolve(tb.adj, tb.wts, tb.mask)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(util.numpy(), np.asarray(jutil), rtol=1e-5)
    np.testing.assert_allclose(gutil.numpy(), np.asarray(jgutil), rtol=1e-5)
    if not with_baseline:
        assert not torch.any(gutil)


@pytest.mark.parametrize("source", ["init", "ckpt"])
def test_resident_pipeline_matches_jax(rng, source):
    jmodel, jparams, tmodel, jcfg, cfg = _models(source)
    jb, tb = _batches(_instances(rng))
    jsolve = jpipe.make_resident_pipeline(jmodel, jcfg)
    tsolve = pipeline.make_resident_pipeline(tmodel, cfg)
    jsup = simple_polynomials_dense(jb.adj, 1)
    tsup = prep.simple_polynomials_dense(tb.adj, 1)
    for _ in range(3):
        w = (rng.random(tb.wts.shape) * tb.mask.numpy()).astype(np.float32)
        jsel, jutil = jsolve(jparams, jsup, jb.adj > 0, jnp.asarray(w),
                             jb.mask)
        sel, util = tsolve(tsup, tb.adj > 0, torch.from_numpy(w), tb.mask)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_allclose(util.numpy(), np.asarray(jutil),
                                   rtol=1e-5)


def test_batched_evaluator_matches_jax(rng):
    jmodel, jparams, tmodel, jcfg, cfg = _models("ckpt")
    inst = _instances(rng, k=9, lo=20, hi=100)
    jagent = types.SimpleNamespace(model=jmodel, flags=jcfg, params=jparams,
                                   feature_mode="gdpg")
    tagent = types.SimpleNamespace(model=tmodel, flags=cfg,
                                   feature_mode="gdpg")
    jutils, jgutils = jpipe.BatchedEvaluator(jagent, 4).evaluate(inst)
    utils, gutils = pipeline.BatchedEvaluator(tagent, 4,
                                              device="cpu").evaluate(inst)
    np.testing.assert_allclose(utils, jutils, rtol=1e-5)
    np.testing.assert_allclose(gutils, jgutils, rtol=1e-5)


# the trained 20-layer checkpoint, and a shallow random model as in the JAX
# package's own bf16 test (a random 20-layer init scores near-ties that
# bf16 rounding reorders by ~1% in both packages)
@pytest.mark.parametrize("source,num_layer", [("ckpt", 20), ("init", 2)])
def test_bfloat16_pipeline_valid_and_within_one_percent(rng, source,
                                                        num_layer):
    inst = _instances(rng, k=8)
    _, tb = _batches(inst)
    res = {}
    for dt in ("float32", "bfloat16"):
        _, _, tmodel, _, cfg = _models(source, dt, num_layer)
        solve = pipeline.make_solve_pipeline(tmodel, cfg)
        sel, util, gutil = solve(tb.adj, tb.wts, tb.mask)
        assert util.dtype == torch.float32
        assert _independent_and_maximal(sel.numpy(), tb.adj.numpy(),
                                        tb.mask.numpy())
        res[dt] = float(util.sum() / gutil.sum())
    assert abs(res["bfloat16"] - res["float32"]) <= 0.01 * res["float32"]
