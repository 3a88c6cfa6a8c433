"""Port parity: the extra agent families (`agents_extra`) and the supervised
diver step against the JAX package, on the same numpy-seeded inputs.

Ports `tests/test_extra.py`'s agent cases and holds each against the JAX
agent under the same seed and parameters (carried over with
`params_from_jax`): legacy DQN replay (losses within rtol 1e-5, memory
kept), MLPAgent and DiverAgent solves (sets equal, utilities within
rtol 1e-5), DiverAgent `head_scores` (rtol 1e-5), the bsf tree search one
graph at a time and in lockstep (equal sets and utilities), the resident
masked evaluation against explicit subgraph extraction, and the supervised
diver step (loss within rtol 1e-5, params within 2·lr + rtol 1e-5).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conftest import random_graph
from distgcn_tpu import agents_extra as jextra
from distgcn_tpu.agents import build_state_arrays as jbuild
from distgcn_tpu.core.graph import GraphBatch as JGraphBatch
from distgcn_tpu.rl import train as jtrain
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu_torch import agents_extra as textra
from distgcn_tpu_torch.agents import build_state_arrays
from distgcn_tpu_torch.core.graph import GraphBatch, pad_bucket
from distgcn_tpu_torch.models.gcn import params_from_jax
from distgcn_tpu_torch.ops.lgs import batched_lgs_multi
from distgcn_tpu_torch.rl import train as ttrain
from distgcn_tpu_torch.utils.config import Config

LR = 1e-3


def small_cfg(**kw):
    base = dict(feature_size=1, hidden1=8, num_layer=1, diver_num=1,
                max_degree=1, predict="mwis", epsilon=0.0, pad_to=64,
                learning_rate=LR)
    base.update(kw)
    return base


def _pair(jcls, tcls, seed=0, **kw):
    cfg = small_cfg(**kw)
    jag = jcls(JConfig(**cfg), seed=seed)
    tag = tcls(Config(**cfg), seed=seed, device="cpu")
    tag.model.load_state_dict(params_from_jax(jag.params))
    if hasattr(tag, "target_params"):
        tag.target_params = {k: v.clone()
                             for k, v in tag.model.state_dict().items()}
    return jag, tag


def check_is(adj, sel):
    adj = sp.csr_matrix(adj)
    ss = sorted(sel)
    for v in ss:
        assert not (set(adj.indices[adj.indptr[v]: adj.indptr[v + 1]]) &
                    set(ss))


def _assert_params_close(tstate, jtree, atol, rtol=1e-5):
    for layer, leaves in jtree.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(
                tstate[f"{layer}.{k}"].detach().numpy(), np.asarray(v),
                rtol=rtol, atol=atol, err_msg=f"{layer}.{k}")


def test_legacy_dqn_agent_replay_keeps_memory(rng):
    jag, tag = _pair(jextra.LegacyDQNAgent, textra.LegacyDQNAgent,
                     epsilon=0.3)
    assert tag.feature_mode == "dqn" and tag.trainer.style == "dqn"
    a = random_graph(rng, 40, 0.1)
    w = rng.random(40)
    for _ in range(6):
        js, ju = jag.solve_mwis(a, w, train=True, grd=1.0)
        ts, tu = tag.solve_mwis(a, w, train=True, grd=1.0)
        assert ts == js and tu == pytest.approx(ju, rel=1e-12)
    for (_, tav, tact, _, trew), (_, jav, jact, _, jrew) in zip(
            tag.memory, jag.memory):
        np.testing.assert_allclose(tav, jav, rtol=1e-5, atol=1e-7)
        assert sorted(tact) == sorted(jact) and trew == jrew
    # the port draws the minibatch from its own random.Random(seed); the
    # JAX agent from the global module, seeded alike
    random.seed(0)
    jloss = jag.replay(6)
    tloss = tag.replay(6)
    assert tloss is not None and np.isfinite(tloss)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert len(tag.memory) == len(jag.memory) == 6   # retained
    assert tag.epsilon == pytest.approx(jag.epsilon)
    _assert_params_close(tag.model.state_dict(), jag.params, atol=2 * LR * 6)


def test_mlp_agent_solves(rng):
    jag, tag = _pair(jextra.MLPAgent, textra.MLPAgent, num_layer=3)
    for _ in range(3):
        a = random_graph(rng, 40, 0.1)
        w = rng.random(40)
        js, ju = jag.solve_mwis(a, w)
        ts, tu = tag.solve_mwis(a, w)
        check_is(a, ts)
        assert tu > 0
        assert ts == js and tu == pytest.approx(ju, rel=1e-5)


def _diver_pair(seed=0, **kw):
    kw = dict(dict(num_layer=2, diver_num=4, hidden1=8, backoff_prob=0.5),
              **kw)
    return _pair(jextra.DiverAgent, textra.DiverAgent, seed=seed, **kw)


def test_diver_head_scores_match_jax(rng):
    jag, tag = _diver_pair(num_layer=3)
    for n in (23, 41, 60):
        a = random_graph(rng, n, 0.12)
        w = rng.random(n)
        want = jag.head_scores(jag.makestate(a, w.reshape(-1, 1)))
        got = tag.head_scores(tag.makestate(a, w.reshape(-1, 1)))
        assert got.shape == (n, 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backoff", [0.0, 0.9])
def test_diver_agent_iterative(rng, backoff):
    jag, tag = _diver_pair(num_layer=3, backoff_prob=backoff)
    for _ in range(3):
        a = random_graph(rng, 40, 0.12)
        w = rng.random(40)
        js, ju = jag.solve_mwis_iterative(a, w)
        ts, tu = tag.solve_mwis_iterative(a, w)
        check_is(a, ts)
        assert tu > 0
        assert ts == js and tu == pytest.approx(ju, rel=1e-5)


def _two_star_trap():
    """Two disjoint stars, centers weight 10, four leaves of weight 3 each.
    Score-guided LGS picks both centers (util 20); the optimum is all
    leaves (util 24), which needs both centers excluded at once."""
    n = 10
    a = np.zeros((n, n), np.float32)
    for c, leaves in ((0, range(1, 5)), (5, range(6, 10))):
        for leaf in leaves:
            a[c, leaf] = a[leaf, c] = 1.0
    w = np.full(n, 3.0)
    w[0] = w[5] = 10.0
    return sp.csr_matrix(a), w


def test_bsf_search_beats_bounded_backoff():
    cfg = dict(num_layer=2, diver_num=4, backoff_prob=1.0, diver_out=4,
               hidden1=4)
    jag, tag = _diver_pair(**cfg)
    # zero the final layer: every head scores 0.5, guided LGS == LGS on w
    jag.params = dict(jag.params)
    jag.params["gc2"] = {k: jnp.zeros_like(v)
                         for k, v in jag.params["gc2"].items()}
    tag.model.load_state_dict(params_from_jax(jag.params))
    a, w = _two_star_trap()
    utils = []
    for seed in range(5):
        jag._rng = np.random.default_rng(seed)
        tag._rng = np.random.default_rng(seed)
        js, ju = jag.solve_mwis_iterative(a, w)
        ts, tu = tag.solve_mwis_iterative(a, w)
        check_is(a, ts)
        assert ts == js and tu == ju
        utils.append(tu)
    assert max(utils) < 24.0   # bounded backoff never reaches the optimum
    jag._rng = np.random.default_rng(0)
    tag._rng = np.random.default_rng(0)
    js, ju = jag.solve_mwis_bsf(a, w, max_pops=32)
    ts, tu = tag.solve_mwis_bsf(a, w, max_pops=32)
    assert tu == ju == 24.0    # bsf finds it
    assert ts == js == set(range(1, 5)) | set(range(6, 10))


@pytest.mark.parametrize("batch_pops", [1, 4])
def test_bsf_matches_jax(rng, batch_pops):
    jag, tag = _diver_pair(backoff_prob=0.7, diver_out=3)
    for _ in range(2):
        n = int(rng.integers(20, 61))
        a = random_graph(rng, n, 0.12)
        w = rng.random(n)
        js, ju = jag.solve_mwis_bsf(a, w, max_pops=12,
                                    batch_pops=batch_pops)
        ts, tu = tag.solve_mwis_bsf(a, w, max_pops=12,
                                    batch_pops=batch_pops)
        check_is(a, ts)
        assert ts == js and tu == pytest.approx(ju, rel=1e-12)


def test_bsf_many_matches_jax_and_single_searches(rng):
    jag, tag = _diver_pair(backoff_prob=0.7, seed=3)
    insts = []
    for _ in range(5):
        n = int(rng.integers(20, 61))
        insts.append((random_graph(rng, n, 0.12), rng.random(n)))
    want = jag.solve_mwis_bsf_many(insts, max_pops=8, batch_pops=4, group=2)
    got = tag.solve_mwis_bsf_many(insts, max_pops=8, batch_pops=4, group=2)
    for (a, _), (ts, tu), (js, ju) in zip(insts, got, want):
        check_is(a, ts)
        assert ts == js and tu == pytest.approx(ju, rel=1e-12)
    # per-instance RNGs: the group size does not change a result
    again = tag.solve_mwis_bsf_many(insts, max_pops=8, batch_pops=4,
                                    group=4)
    assert [s for s, _ in again] == [s for s, _ in got]


@pytest.mark.parametrize("entry", ["single-1", "single-4", "many"])
def test_bsf_matches_jax_on_float32_weights(rng, entry):
    """Float32-valued weights, as the benchmark's set has them: every head's
    utility is one product (`exact_sums`), none summed head by head, and
    the sets and utilities equal the JAX agent's exactly."""
    jag, tag = _diver_pair(backoff_prob=0.7, diver_out=3, seed=4)
    insts = []
    for _ in range(4):
        n = int(rng.integers(20, 61))
        insts.append((random_graph(rng, n, 0.12),
                      rng.random(n).astype(np.float32).astype(np.float64)))
    fallback = textra.DiverAgent.bsf_fallback_states
    children = textra.DiverAgent.bsf_children
    if entry == "many":
        want = jag.solve_mwis_bsf_many(insts, max_pops=8, batch_pops=4,
                                       group=3)
        got = tag.solve_mwis_bsf_many(insts, max_pops=8, batch_pops=4,
                                      group=3)
    else:
        pops = int(entry.split("-")[1])
        want = [jag.solve_mwis_bsf(a, w, max_pops=12, batch_pops=pops)
                for a, w in insts]
        got = [tag.solve_mwis_bsf(a, w, max_pops=12, batch_pops=pops)
               for a, w in insts]
    for (a, _), (ts, tu) in zip(insts, got):
        check_is(a, ts)
    assert got == want
    assert textra.DiverAgent.bsf_fallback_states == fallback
    assert textra.DiverAgent.bsf_children > children


def test_bsf_routes_rollout_entry(rng, monkeypatch):
    """DGCN-RS / CGCN-RS-Seq route through the tree search; the
    DISTGCN_SLOT_POPS knob sets its pops in both packages."""
    jag, tag = _diver_pair(diver_num=2, backoff_prob=0.5)
    a = random_graph(rng, 30, 0.12)
    w = rng.random(30)
    for pops in ("8", "3"):
        monkeypatch.setenv("DISTGCN_SLOT_POPS", pops)
        js, ju = jag.solve_mwis_rollout_wrap(a, w)
        ts, tu = tag.solve_mwis_rollout_wrap(a, w)
        check_is(a, ts)
        assert tu > 0
        assert ts == js and tu == pytest.approx(ju, rel=1e-12)


@pytest.mark.parametrize("bf16", [False, True])
def test_resident_masked_eval_matches_subgraph_extraction(rng, bf16):
    """The resident masked evaluation equals explicit subgraph extraction
    (f32: head scores within 1e-5, the same head sets), and matches the JAX
    agent's resident evaluation (bf16: sets equal, scores within 1e-2)."""
    cfg = dict(num_layer=2, diver_num=3, hidden1=4,
               compute_dtype="bfloat16" if bf16 else "float32")
    jag, tag = _diver_pair(seed=1, **cfg)
    a = random_graph(rng, 40, 0.15)
    n = a.shape[0]
    w = rng.random(n).astype(np.float32) + 0.1
    keep = rng.random(n) < 0.6
    keep[:2] = True
    bucket = pad_bucket(n, 64)
    masks = np.zeros((1, bucket), np.float32)
    masks[0, np.nonzero(keep)[0]] = 1.0
    wfull = np.zeros(bucket, np.float32)
    wfull[:n] = w
    args = (np.zeros(1, np.int32), masks, masks * wfull[None], [n])
    sels, probs = tag._eval_heads_resident(tag._resident_adjs([a], bucket),
                                           *args)
    jsels, jprobs = jag._eval_heads_resident(jag._resident_adjs([a], bucket),
                                             *args)
    np.testing.assert_allclose(probs[0], jprobs[0],
                               atol=1e-2 if bf16 else 1e-5)
    np.testing.assert_array_equal(sels[0], jsels[0])
    if bf16:
        return
    sel_r, probs_r = sels[0], probs[0]
    ridx = np.nonzero(keep)[0]
    sub = sp.csr_matrix(a)[ridx][:, ridx]
    gb = GraphBatch.from_scipy([sub], [w[ridx]], pad_to=bucket,
                               device="cpu")
    feats, sups = build_state_arrays(
        gb.adj, gb.wts, gb.mask, 1, 1, "mwis", tag.feature_mode)
    with torch.no_grad():
        out = (tag.model(feats, sups) * gb.mask[..., None]).numpy()
    d = 3
    heads = out[0, :, : 2 * d].reshape(bucket, d, 2)
    e = np.exp(heads - heads.max(-1, keepdims=True))
    probs_x = (e / e.sum(-1, keepdims=True))[..., 1][: len(ridx)]
    np.testing.assert_allclose(probs_r[ridx], probs_x, atol=1e-5)
    guided = np.zeros((1, d, bucket), np.float32)
    guided[0, :, : len(ridx)] = probs_x.T * w[ridx]
    sel_x = batched_lgs_multi(gb.adj, torch.from_numpy(guided),
                              gb.mask)[0].numpy()[0, :, : len(ridx)]
    for k in range(d):
        got = set(np.nonzero(sel_r[k] == 1)[0].tolist())
        ref = set(ridx[np.nonzero(sel_x[k] == 1)[0]].tolist())
        assert got == ref, f"head {k}: {got} != {ref}"


@pytest.mark.parametrize("skip", [False, True])
def test_supervised_diver_step_matches_jax(rng, skip):
    d = 3
    cfg = small_cfg(num_layer=3, diver_num=d, skip=skip)
    jag = jextra.DiverAgent(JConfig(**cfg), seed=2)
    tag = textra.DiverAgent(Config(**cfg), seed=2, device="cpu")
    tag.model.load_state_dict(params_from_jax(jag.params))
    adjs, wtss, labs = [], [], []
    for n in (25, 40, 33):
        adjs.append(random_graph(rng, n, 0.15))
        wtss.append(rng.random(n))
        labs.append((rng.random(n) < 0.3).astype(np.float32))
    jgb = JGraphBatch.from_scipy(adjs, wtss, pad_to=64)
    tgb = GraphBatch.from_scipy(adjs, wtss, pad_to=64, device="cpu")
    labels = np.zeros((3, 64), np.float32)
    for i, lab in enumerate(labs):
        labels[i, : lab.size] = lab
    jfeats, jsups = jbuild(jgb.adj, jgb.wts, jgb.mask, 1, 1, "mwis", "gdpg")
    feats, sups = build_state_arrays(tgb.adj, tgb.wts, tgb.mask, 1, 1,
                                     "mwis", "gdpg")
    jopt = jtrain.make_optimizer(LR)
    jstep = jtrain.make_supervised_diver_step(jag.model, jopt, d)
    topt = ttrain.make_optimizer(LR)
    tstep = ttrain.make_supervised_diver_step(tag.model, topt, d)
    jparams, jstate = jag.params, jopt.init(jag.params)
    tstate = topt.init(dict(tag.model.named_parameters()))
    for _ in range(2):
        jparams, jstate, jloss = jstep(jparams, jstate, jfeats, jsups,
                                       jgb.mask, jnp.asarray(labels),
                                       jgb.wts)
        tstate, tloss = tstep(tstate, feats, sups, tgb.mask,
                              torch.from_numpy(labels), tgb.wts)
        assert np.isfinite(float(tloss))
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_params_close(tag.model.state_dict(),
                         jax.tree_util.tree_map(np.asarray, jparams),
                         atol=2 * LR)
