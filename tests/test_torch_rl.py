"""Port parity: `rl/losses` and the TF1-exact Adam against JAX.

Losses and metrics are held to the JAX package's functions on the same
seeded inputs at rtol 1e-6 (f32 reductions in two orders). `tf1_adam` is
held to JAX's on identical gradients for three steps, and the staircase
schedule at counts 0, 4999, 5000 and 10000, at rtol 1e-6: the scalars
(`t`, `b1^t`, `b2^t`, `lr_t`) are float32 in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distgcn_tpu.rl import losses as jl
from distgcn_tpu.rl import train as jtrain
from distgcn_tpu_torch.rl import losses as tl
from distgcn_tpu_torch.rl import train as ttrain


def _logits_labels(rng, n=37, c=2):
    logits = rng.standard_normal((n, c)).astype(np.float32)
    cls = rng.integers(0, c, n)
    labels = np.eye(c, dtype=np.float32)[cls]
    return logits, labels


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["softmax_cross_entropy", "accuracy",
                                  "f1_score", "f1_precision_recall"])
def test_two_argument_metrics_match_jax(rng, name):
    logits, labels = _logits_labels(rng)
    got = getattr(tl, name)(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    want = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(labels))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_weighted_and_masked_losses_match_jax(rng):
    logits, labels = _logits_labels(rng, c=3)
    w = rng.random(logits.shape[0]).astype(np.float32)
    mask = rng.random(logits.shape[0]) < 0.6
    t = [torch.from_numpy(x) for x in (logits, labels, w, mask)]
    j = [jnp.asarray(x) for x in (logits, labels, w, mask)]
    _close(tl.weighted_softmax_cross_entropy(t[0], t[1], t[2]),
           jl.weighted_softmax_cross_entropy(j[0], j[1], j[2]))
    _close(tl.masked_softmax_cross_entropy(t[0], t[1], t[3]),
           jl.masked_softmax_cross_entropy(j[0], j[1], j[3]))
    _close(tl.masked_accuracy(t[0], t[1], t[3]),
           jl.masked_accuracy(j[0], j[1], j[3]))


@pytest.mark.parametrize("diver_num", [1, 4])
def test_diver_losses_match_jax(rng, diver_num):
    n = 29
    logits = rng.standard_normal((n, 2 * diver_num + 1)).astype(np.float32)
    labels01 = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    t = [torch.from_numpy(x) for x in (logits, labels01, w)]
    j = [jnp.asarray(x) for x in (logits, labels01, w)]
    np.testing.assert_array_equal(
        tl.diver_heads(t[0], diver_num).numpy(),
        np.asarray(jl.diver_heads(j[0], diver_num)))
    _close(tl.hindsight_diver_ce(t[0], t[1], t[2], diver_num),
           jl.hindsight_diver_ce(j[0], j[1], j[2], diver_num))
    _close(tl.hindsight_diver_accuracy(t[0], t[1], diver_num),
           jl.hindsight_diver_accuracy(j[0], j[1], diver_num))
    for g, w_ in zip(tl.hindsight_diver_f1(t[0], t[1], diver_num),
                     jl.hindsight_diver_f1(j[0], j[1], diver_num)):
        _close(g, w_)


@pytest.mark.parametrize("diver_num", [1, 3])
def test_q_losses_match_jax(rng, diver_num):
    out = rng.standard_normal((31, diver_num + 1)).astype(np.float32)
    labels = rng.standard_normal((31, 1)).astype(np.float32)
    _close(tl.gcn_dqn_loss(torch.from_numpy(out), torch.from_numpy(labels),
                           diver_num),
           jl.gcn_dqn_loss(jnp.asarray(out), jnp.asarray(labels), diver_num))
    _close(tl.gcn2_dqn_loss(torch.from_numpy(out), torch.from_numpy(labels)),
           jl.gcn2_dqn_loss(jnp.asarray(out), jnp.asarray(labels)))


def _tree(rng):
    return {"gc1": {"w_0": rng.standard_normal((1, 8)).astype(np.float32),
                    "bias": rng.standard_normal(8).astype(np.float32)},
            "gc2": {"w_1": rng.standard_normal((8, 1)).astype(np.float32)}}


def _flat(tree):
    return {f"{layer}.{k}": torch.from_numpy(v.copy())
            for layer, leaves in tree.items() for k, v in leaves.items()}


@pytest.mark.parametrize("learning_decay", [1.0, 0.9])
def test_tf1_adam_matches_jax_for_three_steps(rng, learning_decay):
    import optax
    params = _tree(rng)
    jopt = jtrain.make_optimizer(1e-3, learning_decay)
    topt = ttrain.make_optimizer(1e-3, learning_decay)
    jp = {k: {n: jnp.asarray(v) for n, v in d.items()}
          for k, d in params.items()}
    jstate = jopt.init(jp)
    tp = _flat(params)
    tstate = topt.init(tp)
    for _ in range(3):
        grads = _tree(rng)
        jg = {k: {n: jnp.asarray(v) for n, v in d.items()}
              for k, d in grads.items()}
        jupd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = topt.update(_flat(grads), tstate)
        ttrain.apply_updates(tp, tupd)
        for layer, leaves in jupd.items():
            for k, u in leaves.items():
                name = f"{layer}.{k}"
                _close(tupd[name], u)
                _close(tp[name], jp[layer][k])
                _close(tstate["m"][name], jstate["m"][layer][k])
                _close(tstate["v"][name], jstate["v"][layer][k])
    assert tstate["count"] == int(jstate["count"]) == 3


@pytest.mark.parametrize("count", [0, 4999, 5000, 10000])
def test_staircase_schedule_matches_optax(count):
    import optax
    want = optax.exponential_decay(1e-3, 5000, 0.96, staircase=True)(
        jnp.asarray(count, jnp.int32))
    got = ttrain.exponential_decay(1e-3, 5000, 0.96)(count)
    assert got.dtype == torch.float32
    _close(got, want)
