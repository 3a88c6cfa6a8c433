"""Port parity: the ChebGCN forward against Flax on the same params.

Params come from Flax ``init`` or from the repo's ``model/*mwis_dqn*/``
checkpoints and reach the port through `params_from_jax`. Tolerance is the
JAX package's TF1-golden one (atol 1e-5, rtol 1e-4); both sides compute in
full f32, and the measured gap is ~1.5e-6.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_graph
from distgcn_tpu.core.graph import GraphBatch
from distgcn_tpu.core.prep import simple_polynomials_dense
from distgcn_tpu.models import gcn as jgcn
from distgcn_tpu.models import layers as jlayers
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu.utils.serialization import load_params as jload_params
from distgcn_tpu_torch.models import gcn as tgcn
from distgcn_tpu_torch.models import layers as tlayers
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.serialization import load_params

TOL = dict(atol=1e-5, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = sorted(glob.glob(os.path.join(REPO, "model", "*mwis_dqn*",
                                    "params.npz")))


def _inputs(rng, feature_size, b=2, n=40, pad=64):
    adjs = [random_graph(rng, n=n - 7 * i, p=0.15) for i in range(b)]
    gb = GraphBatch.from_scipy(adjs, [np.ones(a.shape[0]) for a in adjs],
                               pad_to=pad)
    x = rng.random((b, pad, feature_size)).astype(np.float32)
    x = x * np.asarray(gb.mask)[..., None]
    sup = np.array(simple_polynomials_dense(gb.adj, 1))
    return x, sup, np.array(gb.mask)


def _torch_forward(model, x, sup, mask=None):
    with torch.no_grad():
        m = None if mask is None else torch.from_numpy(mask)
        return model(torch.from_numpy(x), torch.from_numpy(sup), m).numpy()


def test_zoo_has_the_six_mwis_dqn_checkpoints():
    assert len(ZOO) == 6, ZOO


# the skip head exists on the gcn_dqn family, the dueling head on gcn2_dqn
@pytest.mark.parametrize("family,head", [
    ("gcn_dqn", "plain"), ("gcn_dqn", "skip"),
    ("gcn2_dqn", "plain"), ("gcn2_dqn", "is_dual")])
@pytest.mark.parametrize("num_layer", [1, 20])
def test_chebgcn_matches_flax_init(rng, family, num_layer, head):
    kw = dict(feature_size=3, hidden1=32, num_layer=num_layer, diver_num=2,
              max_degree=1, skip=head == "skip")
    is_dual = head == "is_dual"
    jmodel = jgcn.make_model_from_config(JConfig(**kw), family,
                                         is_dual=is_dual)
    x, sup, mask = _inputs(rng, 3)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x),
                         jnp.asarray(sup))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(sup), jnp.asarray(mask)))
    tmodel = tgcn.make_model_from_config(
        Config(**kw), family, is_dual=is_dual,
        params=tgcn.params_from_jax(params), device="cpu")
    got = _torch_forward(tmodel, x, sup, mask)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("path", ZOO, ids=lambda p: p.split(os.sep)[-2])
@pytest.mark.parametrize("family", ["gcn_dqn", "gcn2_dqn"])
def test_chebgcn_matches_flax_on_zoo_checkpoint(rng, path, family):
    tree = load_params(path)
    jtree = jload_params(path)
    assert tree.keys() == jtree.keys()
    first, last = tree["gc1"], tree[f"gc{len(tree)}"]
    kw = dict(feature_size=first["w_0"].shape[0],
              hidden1=first["w_0"].shape[1], num_layer=len(tree),
              diver_num=last["w_0"].shape[1],
              max_degree=len([k for k in first if k.startswith("w_")]) - 1)
    has_bias = any("bias" in layer for layer in tree.values())
    # bias presence comes from the checkpoint (agents._reconcile_arch)
    jmodel = dataclasses.replace(
        jgcn.make_model_from_config(JConfig(**kw), family), use_bias=has_bias)
    tmodel = tgcn.make_model_from_config(
        Config(**kw), family, params=tgcn.params_from_jax(tree),
        device="cpu")
    assert tmodel.use_bias == has_bias
    x, sup, mask = _inputs(rng, kw["feature_size"])
    want = np.asarray(jmodel.apply({"params": jtree}, jnp.asarray(x),
                                   jnp.asarray(sup)))
    got = _torch_forward(tmodel, x, sup)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


def test_layer_helpers_match_jax(rng):
    np.testing.assert_array_equal(
        tgcn.skip_zeros_kernel((6, 5)).numpy(),
        np.asarray(jgcn.skip_zeros_kernel(None, (6, 5))))
    x = (rng.random((2, 7, 3)).astype(np.float32) - 0.5)
    mask = np.array([[1] * 7, [1] * 4 + [0] * 3], bool)
    for m in (None, mask):
        want = np.asarray(jgcn.dueling_head(
            jnp.asarray(x), None if m is None else jnp.asarray(m)))
        got = tgcn.dueling_head(torch.from_numpy(x),
                                None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tlayers.leaky_relu02(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.leaky_relu02(jnp.asarray(x))), rtol=0, atol=0)


def test_glorot_uniform_range_and_generator():
    g = torch.Generator().manual_seed(0)
    w = tlayers.glorot_uniform((32, 16), g)
    limit = (6.0 / 48) ** 0.5
    assert w.shape == (32, 16) and float(w.abs().max()) <= limit
    assert float(w.std()) > 0.5 * limit / 3 ** 0.5
    again = tlayers.glorot_uniform((32, 16), torch.Generator().manual_seed(0))
    assert torch.equal(w, again)


def test_dense_layer_matches_flax(rng):
    x = rng.random((2, 5, 4)).astype(np.float32)
    jd = jlayers.Dense(3, use_bias=True)
    params = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"weights": params["weights"], "bias": params["bias"] + 0.25}
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    td = tlayers.Dense(4, 3, use_bias=True)
    td.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in params.items()})
    with torch.no_grad():
        got = td(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("is_dual", [False, True])
@pytest.mark.parametrize("num_layer", [2, 4])
def test_mlp2_matches_flax_init(rng, num_layer, is_dual):
    kw = dict(feature_size=3, hidden1=16, num_layer=num_layer, diver_num=2)
    jmodel = jgcn.make_model_from_config(JConfig(**kw), "mlp2",
                                         is_dual=is_dual)
    x = rng.random((2, 40, 3)).astype(np.float32) - 0.3
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    tmodel = tgcn.make_model_from_config(
        Config(**kw), "mlp2", is_dual=is_dual,
        params=tgcn.params_from_jax(params), device="cpu")
    assert isinstance(tmodel, tgcn.MLP2)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 40, 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("wts_init", ["random", "zeros"])
@pytest.mark.parametrize("skip", [False, True])
def test_deep_diver_matches_flax_init(rng, skip, wts_init):
    kw = dict(feature_size=3, hidden1=16, num_layer=3, diver_num=4,
              max_degree=1, skip=skip, wts_init=wts_init)
    jmodel = jgcn.make_model_from_config(JConfig(**kw), "deep_diver")
    x, sup, mask = _inputs(rng, 3)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x),
                         jnp.asarray(sup))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(sup), jnp.asarray(mask)))
    tmodel = tgcn.make_model_from_config(
        Config(**kw), "deep_diver", params=tgcn.params_from_jax(params),
        device="cpu")
    assert isinstance(tmodel, tgcn.GCNDeepDiver) and not tmodel.use_bias
    got = _torch_forward(tmodel, x, sup, mask)
    assert got.shape == want.shape == (2, 64, 8)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[~mask] == 0)


DIVERS = sorted(glob.glob(os.path.join(REPO, "model", "*mwis_diver",
                                       "params.npz")))


@pytest.mark.parametrize("path", DIVERS, ids=lambda p: p.split(os.sep)[-2])
def test_deep_diver_matches_flax_on_diver_checkpoint(rng, path):
    """The repo's two diver32 checkpoints: 20 layers, 32 wide, 64 logits,
    no bias; they load into the port's deep_diver family. The logits reach
    ~10 in magnitude after 20 layers, so the absolute tolerance is 1e-5 of
    the largest logit (f32 rounding accumulates with the scale; the
    measured gap is ~5e-6 of it)."""
    tree = load_params(path)
    jtree = jload_params(path)
    assert len(tree) == 20 and tree["gc20"]["w_0"].shape == (32, 64)
    kw = dict(feature_size=32, hidden1=32, num_layer=20, diver_num=32,
              max_degree=1)
    jmodel = jgcn.make_model_from_config(JConfig(**kw), "deep_diver")
    tmodel = tgcn.make_model_from_config(
        Config(**kw), "deep_diver", params=tgcn.params_from_jax(tree),
        device="cpu")
    x, sup, mask = _inputs(rng, 32)
    want = np.asarray(jmodel.apply({"params": jtree}, jnp.asarray(x),
                                   jnp.asarray(sup), jnp.asarray(mask)))
    got = _torch_forward(tmodel, x, sup, mask)
    assert got.shape == (2, 64, 64) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_diver_checkpoints_present():
    assert len(DIVERS) == 2, DIVERS


@pytest.mark.parametrize("shape", [(5, 3), (2, 7, 4)])
def test_maxpool_aggregate_matches_jax(rng, shape):
    n, f = shape[-2], shape[-1]
    lead = shape[:-2]
    x = (rng.random(lead + (n, n)) < 0.4).astype(np.float32)
    x = x * (rng.random(x.shape).astype(np.float32) + 0.5)
    y = rng.random(lead + (n, f)).astype(np.float32) - 0.5
    want = np.asarray(jlayers.maxpool_aggregate(jnp.asarray(x),
                                                jnp.asarray(y)))
    got = tlayers.maxpool_aggregate(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == want.shape == lead + (n, f)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown model family"):
        tgcn.make_model_from_config(Config(), "gcn3", device="cpu")


def test_random_init_is_seeded():
    cfg = Config(feature_size=1, hidden1=8, num_layer=3, diver_num=1)
    a = tgcn.make_model_from_config(cfg, "gcn2_dqn", device="cpu")
    b = tgcn.make_model_from_config(cfg, "gcn2_dqn", device="cpu")
    c = tgcn.make_model_from_config(cfg.replace(seed=7), "gcn2_dqn",
                                    device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["gc1.w_0"], sc["gc1.w_0"])
    assert "gc1.bias" in sa and sa["gc3.w_1"].shape == (8, 1)
