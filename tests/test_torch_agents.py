"""Port parity: the agents, the replay trainer and training checkpoints.

The JAX agent and the port's agent hold the same parameters (carried over
with `params_from_jax`). Tolerances:
- `solve_mwis`: selections bit-equal (LGS compares the scores' order),
  memorized scores within rtol 1e-5;
- `train_minibatch` on one minibatch: labels within rtol 1e-6 (float64
  targets cast to f32 in both), per-sample losses within rtol 1e-5, the
  first sample's gradients within rtol 1e-5 + 1e-7·max|g|, and every
  parameter after the K per-sample TF1 Adam steps within 2·lr·K + rtol 1e-5
  (the first steps move a parameter by about ±lr, so a gradient near 0
  whose sign differs between two summation orders moves it by at most
  2·lr a step).
The JAX per-sample losses come from chaining the JAX trainer's own 1-sample
step over the minibatch it built (a scan of one body per sample), its
first-sample gradients from that step with an optimizer that returns the
gradients as its state.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import random_graph
from distgcn_tpu.agents import DQNAgent as JDQNAgent
from distgcn_tpu.rl import checkpoint as jckpt
from distgcn_tpu.solvers.greedy import greedy_search
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu.utils.serialization import save_params as jsave_params
from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.models.gcn import params_from_jax, params_to_jax
from distgcn_tpu_torch.rl import checkpoint as tckpt
from distgcn_tpu_torch.rl.train import replay_loss
from distgcn_tpu_torch.utils.config import Config

LR = 1e-3
BASE = dict(feature_size=1, hidden1=8, diver_num=1, max_degree=1,
            predict="mwis", epsilon=0.0, pad_to=64, learning_rate=LR)


def _agents(family, num_layer, **kw):
    cfg = dict(BASE, num_layer=num_layer, **kw)
    jag = JDQNAgent(JConfig(**cfg), model_family=family)
    tag = DQNAgent(Config(**cfg), model_family=family, device="cpu")
    tag.model.load_state_dict(params_from_jax(jag.params))
    tag.target_params = {k: v.clone()
                         for k, v in tag.model.state_dict().items()}
    return jag, tag


def _graphs(rng, k=5, lo=20, hi=60):
    out = []
    for _ in range(k):
        n = int(rng.integers(lo, hi))
        out.append((random_graph(rng, n, 0.1), rng.random(n)))
    return out


def _memorize(agent, graphs):
    for a, w in graphs:
        _, grd = greedy_search(a, w)
        agent.solve_mwis(a, w, train=True, grd=grd)


def _assert_params_close(tstate, jtree, atol, rtol=1e-5):
    for layer, leaves in jtree.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(
                tstate[f"{layer}.{k}"].detach().numpy(), np.asarray(v),
                rtol=rtol, atol=atol, err_msg=f"{layer}.{k}")


@pytest.mark.parametrize("family", ["gcn_dqn", "gcn2_dqn"])
@pytest.mark.parametrize("num_layer", [1, 3])
def test_solve_mwis_matches_jax_with_equal_memory(rng, family, num_layer):
    jag, tag = _agents(family, num_layer)
    graphs = _graphs(rng)
    for a, w in graphs:
        _, grd = greedy_search(a, w)
        jsel, jutil = jag.solve_mwis(a, w, train=True, grd=grd)
        tsel, tutil = tag.solve_mwis(a, w, train=True, grd=grd)
        assert tsel == jsel
        assert tutil == pytest.approx(jutil, rel=1e-12)
    assert len(tag.memory) == len(jag.memory) == len(graphs)
    for (ts, tav, tact, tnext, trew), (js, jav, jact, jnext, jrew) in zip(
            tag.memory, jag.memory):
        assert (ts["adj"] != js["adj"]).nnz == 0
        np.testing.assert_array_equal(ts["wts"], js["wts"])
        np.testing.assert_allclose(tav, jav, rtol=1e-5, atol=1e-7)
        assert sorted(tact) == sorted(jact) and tnext == jnext
        assert trew == pytest.approx(jrew, rel=1e-12)
    np.testing.assert_allclose(list(tag.reward_mem), list(jag.reward_mem))


def _jax_reference(jag, minibatch):
    """JAX's own replay of `minibatch`: (labels, per-sample losses, first
    sample's gradients, mean loss, params after)."""
    tr = jag.trainer
    seen = {}
    make = tr._make_step

    def recording(num_samples):
        step = make(num_samples)

        def wrapped(params, opt_state, adj, wts, mask, labels):
            seen.update(adj=adj, wts=wts, mask=mask, labels=labels)
            return step(params, opt_state, adj, wts, mask, labels)
        return wrapped

    p0, s0 = jag.params, tr.opt_state
    tr._make_step = recording
    mean_loss = tr.train_minibatch(minibatch)
    tr._make_step = make
    after = jag.params

    one = make(1)
    params, state, losses = p0, s0, []
    for i in range(len(minibatch)):
        sl = {k: v[i: i + 1] for k, v in seen.items()}
        params, state, loss = one(params, state, sl["adj"], sl["wts"],
                                  sl["mask"], sl["labels"])
        losses.append(float(loss))

    stash = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    adam, tr.optimizer = tr.optimizer, stash
    grads_step = make(1)
    tr.optimizer = adam
    _, grads, _ = grads_step(p0, stash.init(p0), seen["adj"][:1],
                             seen["wts"][:1], seen["mask"][:1],
                             seen["labels"][:1])
    return seen["labels"], np.array(losses), grads, mean_loss, after


@pytest.mark.parametrize("family", ["gcn_dqn", "gcn2_dqn"])
@pytest.mark.parametrize("num_layer", [1, 3])
@pytest.mark.parametrize("style", ["gdpg", "dqn", "dqn_origin"])
def test_train_minibatch_matches_jax(rng, family, num_layer, style):
    jag, tag = _agents(family, num_layer)
    jag.trainer.style = tag.trainer.style = style
    _memorize(jag, _graphs(rng))
    minibatch = list(jag.memory)
    k = len(minibatch)

    adj, wts, mask, labels = tag.trainer.prepare(minibatch)
    jlabels, jlosses, jgrads, jmean, jafter = _jax_reference(jag, minibatch)
    np.testing.assert_allclose(labels.numpy(), np.asarray(jlabels),
                               rtol=1e-6, atol=1e-7)

    from distgcn_tpu_torch.agents import build_state_arrays
    f, s = build_state_arrays(adj, wts, mask > 0, 1, 1)
    params = dict(tag.model.named_parameters())
    loss0 = replay_loss(tag.model, f[0], s[0], labels[0], mask[0],
                        tag.flags.weight_decay)
    grads = dict(zip(params, torch.autograd.grad(loss0,
                                                 list(params.values()))))
    gmax = max(float(np.abs(np.asarray(v)).max())
               for leaves in jgrads.values() for v in leaves.values())
    _assert_params_close(grads, jgrads, atol=1e-7 * gmax)

    losses = tag.trainer.step(adj, wts, mask, labels)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    assert float(losses.mean()) == pytest.approx(jmean, rel=1e-5)
    _assert_params_close(tag.model.state_dict(), jafter, atol=2 * LR * k)
    assert tag.trainer.opt_state["count"] == int(
        jag.trainer.opt_state["count"]) == k


def test_replay_memory_epsilon_and_target_sync_match_jax(rng):
    jag, tag = _agents("gcn2_dqn", 1, epsilon=0.5)
    assert tag.replay(3) is None and jag.replay(3) is None
    synced = {"jax": [], "port": []}
    for call in range(1, 14):
        graphs = _graphs(rng, k=2, lo=20, hi=30)
        _memorize(jag, graphs)
        _memorize(tag, graphs)
        jbefore = jax.tree_util.tree_map(np.asarray, jag.params)
        tbefore = {k: v.clone() for k, v in tag.model.state_dict().items()}
        eps = tag.epsilon
        assert tag.replay(2) is not None and jag.replay(2) is not None
        assert len(tag.memory) == 0 and len(jag.memory) == 0
        assert tag.epsilon == pytest.approx(eps * tag.epsilon_decay)
        assert tag.epsilon == pytest.approx(jag.epsilon)
        assert tag.update_cnt == jag.update_cnt
        if all(np.array_equal(np.asarray(v), jbefore[layer][n])
               for layer, leaves in jag.target_params.items()
               for n, v in leaves.items()):
            synced["jax"].append(call)
        if all(torch.equal(v, tbefore[k])
               for k, v in tag.target_params.items()):
            synced["port"].append(call)
    # synced on the first replay, then whenever update_cnt exceeds C=10
    assert synced["port"] == synced["jax"] == [1, 12]


@pytest.mark.parametrize("family,src_family,cfg", [
    # shapes differ: a 3-layer, 8-wide checkpoint, agents of 1 layer, 16 wide
    ("gcn_dqn", "gcn_dqn", dict(num_layer=1, hidden1=16)),
    ("gcn2_dqn", "gcn2_dqn", dict(num_layer=1, hidden1=16)),
    # bias structure differs: a biased (gcn2_dqn) checkpoint, gcn_dqn agent
    ("gcn_dqn", "gcn2_dqn", dict(num_layer=3)),
])
def test_reconcile_arch_rebuilds_from_a_mismatched_npz(rng, tmp_path, family,
                                                       src_family, cfg):
    src, _ = _agents(src_family, 3)
    os.makedirs(tmp_path / "m")
    jsave_params(str(tmp_path / "m" / "params.npz"), src.params)
    cfg = dict(BASE, **cfg)
    jag = JDQNAgent(JConfig(**cfg), model_family=family)
    tag = DQNAgent(Config(**cfg), model_family=family, device="cpu")
    assert jag.load(str(tmp_path / "m")) and tag.load(str(tmp_path / "m"))
    assert (tag.flags.num_layer, tag.flags.hidden1) == (
        jag.flags.num_layer, jag.flags.hidden1) == (3, 8)
    assert tag.model.use_bias == jag.model.use_bias == (
        src_family == "gcn2_dqn")
    _assert_params_close(tag.model.state_dict(), src.params, atol=0, rtol=0)
    _assert_params_close(tag.target_params, src.params, atol=0, rtol=0)
    assert sorted(tag.trainer.opt_state["m"]) == sorted(
        tag.model.state_dict())
    for a, w in _graphs(rng, k=3):
        assert tag.solve_mwis(a, w) == jag.solve_mwis(a, w)
    assert not tag.load(str(tmp_path / "missing"))


def test_reconcile_keeps_the_checkpoint_bias_when_shapes_also_differ(
        tmp_path):
    # the JAX agent loses the bias override here (ROADMAP §C): its shape
    # rebuild makes a bias-free gcn_dqn model again
    src, _ = _agents("gcn2_dqn", 3)
    os.makedirs(tmp_path / "m")
    jsave_params(str(tmp_path / "m" / "params.npz"), src.params)
    cfg = dict(BASE, num_layer=1, hidden1=16)
    tag = DQNAgent(Config(**cfg), model_family="gcn_dqn", device="cpu")
    assert tag.load(str(tmp_path / "m"))
    assert tag.model.use_bias and tag.flags.num_layer == 3
    _assert_params_close(tag.model.state_dict(), src.params, atol=0, rtol=0)


def _train_a_little(rng, jag, tag):
    """One further replay step in each agent on the same minibatch (the
    two packages draw minibatches from different generators)."""
    _memorize(jag, _graphs(rng, k=4))
    minibatch = list(jag.memory)
    return (jag.trainer.train_minibatch(minibatch),
            tag.trainer.train_minibatch(minibatch))


def _assert_same_state(tag, jag):
    _assert_params_close(tag.model.state_dict(), jag.params, atol=0, rtol=0)
    _assert_params_close(tag.target_params, jag.target_params, atol=0,
                         rtol=0)
    st, jst = tag.trainer.opt_state, jag.trainer.opt_state
    assert st["count"] == int(jst["count"])
    _assert_params_close(st["m"], jst["m"], atol=0, rtol=0)
    _assert_params_close(st["v"], jst["v"], atol=0, rtol=0)
    assert tag.epsilon == jag.epsilon and tag.update_cnt == jag.update_cnt


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_the_others_training_state(rng, tmp_path,
                                                        writer):
    jag, tag = _agents("gcn2_dqn", 3, epsilon=0.5)
    # the writer trains first, so its state differs from the reader's
    if writer == "jax":
        _memorize(jag, _graphs(rng, k=4))
        jag.replay(4)
        jckpt.save_training_state(str(tmp_path), jag, best_ratio=0.9,
                                  step=7)
        meta = tckpt.load_training_state(str(tmp_path), tag)
    else:
        _memorize(tag, _graphs(rng, k=4))
        tag.replay(4)
        tckpt.save_training_state(str(tmp_path), tag, best_ratio=0.9,
                                  step=7)
        meta = jckpt.load_training_state(str(tmp_path), jag)
    assert meta["best_ratio"] == 0.9 and meta["step"] == 7
    with open(tmp_path / "train_meta.json") as f:
        assert json.load(f)["update_cnt"] == 1
    _assert_same_state(tag, jag)
    # one further replay in each agrees within the replay tolerance
    jloss, tloss = _train_a_little(rng, jag, tag)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    _assert_params_close(tag.model.state_dict(), jag.params, atol=2 * LR * 4)


def test_opt_state_leaf_mismatch_warns_and_keeps_fresh_moments(tmp_path):
    _, tag = _agents("gcn2_dqn", 1)
    tckpt.save_training_state(str(tmp_path), tag)
    np.savez(tmp_path / "opt_state.npz", np.int32(3), np.zeros(2))
    with pytest.warns(UserWarning, match="NOT restored"):
        tckpt.load_training_state(str(tmp_path), tag)
    assert tag.trainer.opt_state["count"] == 0
    assert tckpt.load_training_state(str(tmp_path / "none"), tag) is None


def test_params_to_jax_inverts_params_from_jax():
    jag, tag = _agents("gcn2_dqn", 3)
    tree = params_to_jax(tag.model.state_dict())
    assert sorted(tree) == sorted(jag.params)
    _assert_params_close(params_from_jax(tree), jag.params, atol=0, rtol=0)
