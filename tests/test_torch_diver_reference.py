"""The port's diver (`models.gcn.GCNDeepDiver`, `agents_extra.DiverAgent`)
against the benchmark's plain reference (`bench_h100/reference/diver.py`)
on the CPU: the forward on seeded random weights, one device call of the
search (`_bsf_eval`), whole lockstep searches at two group sizes, two
single searches in a row on one agent's generator, the published
checkpoint at its widths, and the search's program spans and counters.

Tolerances: the forward and the head probabilities are compared with
rtol 1e-5. Both sides run the same float32 products in the same order,
so on one machine they agree to the bit; the tolerance leaves room for a
BLAS that blocks a reduction differently between the batched and the
plain product (a few ulps). Selections, sets and utilities are compared
exactly: they are discrete, or float64 sums of the same weights in the
same order, and the search branches on them.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from bench_h100.reference import checkpoint, dense
from bench_h100.reference import diver as ref
from distgcn_tpu_torch import agents_extra
from distgcn_tpu_torch.agents_extra import DiverAgent
from distgcn_tpu_torch.models.gcn import make_model_from_config
from distgcn_tpu_torch.utils.config import Config

CKPT = "model/result_ERUNI_deep_ld32_c32_l20_cheb1_diver32_mwis_diver"
SMALL = dict(feature_size=4, hidden1=8, num_layer=3, diver_num=4,
             max_degree=1, predict="mwis", pad_to=32, backoff_prob=0.3,
             diver_out=4)
PUBLISHED = dict(feature_size=32, hidden1=32, num_layer=20, diver_num=32,
                 max_degree=1, predict="mwis", pad_to=64, backoff_prob=0.3,
                 diver_out=32)


def _graphs(seed, count, n_lo, n_hi, p=0.15):
    """(dense [n, n] float32 0/1, float32 weights) of seeded ER graphs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(n_lo, n_hi + 1))
        a = np.triu(rng.random((n, n)) < p, 1)
        out.append(((a | a.T).astype(np.float32),
                    rng.random(n).astype(np.float32)))
    return out


def _layers(model):
    return [{"w_0": getattr(model, f"gc{i + 1}").w_0.detach(),
             "w_1": getattr(model, f"gc{i + 1}").w_1.detach()}
            for i in range(model.num_layer)]


def _agent(cfg, seed=3):
    return DiverAgent(Config(**cfg), seed=seed, device="cpu")


def _reference_search(agent, layers, graphs, max_pops, batch_pops, group,
                      calls=None):
    f = agent.flags
    return ref.search(layers, [a for a, _ in graphs], [w for _, w in graphs],
                      agent._seed, max_pops, batch_pops, group,
                      min(f.diver_num, f.diver_out), f.backoff_prob,
                      f.feature_size, f.pad_to, "cpu", calls=calls)


def _program_search(agent, graphs, max_pops, batch_pops, group):
    insts = [(sp.csr_matrix(a), w) for a, w in graphs]
    return agent.solve_mwis_bsf_many(insts, max_pops=max_pops,
                                     batch_pops=batch_pops, group=group)


def test_forward_matches_the_reference_on_seeded_weights():
    cfg = Config(**SMALL)
    model = make_model_from_config(
        cfg, "deep_diver", generator=torch.Generator().manual_seed(7),
        device="cpu")
    adj = np.zeros((3, 40, 40), np.float32)
    mask = np.zeros((3, 40), bool)
    for i, (a, _) in enumerate(_graphs(1, 3, 20, 40)):
        adj[i, : a.shape[0], : a.shape[0]] = a
        mask[i, : a.shape[0]] = True
    sup = dense.supports(torch.from_numpy(adj), torch.from_numpy(mask))
    x = torch.rand((3, 40, 4), generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        got = model(x, sup)
    want = ref.forward(_layers(model), x, sup)
    assert got.shape == want.shape == (3, 40, 8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_bsf_eval_matches_the_reference():
    agent = _agent(SMALL)
    graphs = _graphs(2, 3, 15, 32)
    adjs = np.zeros((3, 32, 32), np.float32)
    for i, (a, _) in enumerate(graphs):
        adjs[i, : a.shape[0], : a.shape[0]] = a
    rng = np.random.default_rng(4)
    gidx = np.array([0, 1, 2, 2, 0], np.int64)
    masks = np.zeros((5, 32), np.float32)
    wts = np.zeros((5, 32), np.float32)
    for q, g in enumerate(gidx):
        n = graphs[g][0].shape[0]
        masks[q, :n] = rng.random(n) < 0.7
        wts[q, :n] = graphs[g][1] * masks[q, :n]
    args = [torch.from_numpy(v) for v in (gidx, wts, masks)]
    sel, probs = agent._bsf_eval(torch.from_numpy(adjs).to(torch.int8),
                                 *args)
    rsel, rprobs = ref.evaluate(_layers(agent.model), torch.from_numpy(adjs),
                                args[0], args[2], args[1],
                                SMALL["feature_size"])
    torch.testing.assert_close(probs, rprobs, rtol=1e-5, atol=1e-7)
    assert torch.equal(sel, rsel)
    assert not (sel == -1).any()                 # every completion is whole


@pytest.mark.parametrize("group", [1, 3])
def test_bsf_many_matches_the_reference_search(group):
    agent = _agent(SMALL)
    graphs = _graphs(5, 6, 12, 30)
    got = _program_search(agent, graphs, 8, 4, group)
    want = _reference_search(agent, _layers(agent.model), graphs, 8, 4,
                             group)
    assert got == want
    assert all(u > 0 for _, u in got)


def _reference_single(agent, layers, graph, rng, max_pops, batch_pops):
    """The reference's search of one instance drawing from `rng`, as
    `solve_mwis_bsf` draws from the agent's generator."""
    f = agent.flags
    a, w = graph
    n = w.size
    n_pad = max(f.pad_to, -(-n // f.pad_to) * f.pad_to)
    adj = np.zeros((1, n_pad, n_pad), np.float32)
    adj[0, :n, :n] = a
    wrow = np.zeros(n_pad, np.float32)
    wrow[:n] = w
    s = ref.Search(a, w, max_pops, batch_pops,
                   min(f.diver_num, f.diver_out), f.backoff_prob, rng)
    while not s.done:
        batch = s.pop()
        if not batch:
            continue
        masks = np.zeros((len(batch), n_pad), np.float32)
        for i, (labels, _, _) in enumerate(batch):
            masks[i, :n] = labels == -1
        mk = torch.from_numpy(masks)
        sel, probs = ref.evaluate(
            layers, torch.from_numpy(adj),
            torch.zeros(len(batch), dtype=torch.int64), mk,
            mk * torch.from_numpy(wrow), f.feature_size)
        s.absorb(batch, sel.numpy()[:, :, :n], probs.numpy()[:, :n])
    return s.result()


@pytest.mark.parametrize("entry, group", [("single", None), ("many", 1),
                                          ("many", 3)])
def test_whole_searches_match_the_reference(entry, group):
    """The array `absorb` through whole searches: two single searches in a
    row on one agent (its shared generator, left as the reference leaves
    it) and lockstep searches, 12 pops taken 4 at a time."""
    agent = _agent(SMALL, seed=5)
    layers = _layers(agent.model)
    graphs = _graphs(12, 4, 12, 30)
    fallback = DiverAgent.bsf_fallback_states
    children = DiverAgent.bsf_children
    if entry == "single":
        for a, w in graphs[:2]:
            rng = np.random.default_rng()
            rng.bit_generator.state = agent._rng.bit_generator.state
            got = agent.solve_mwis_bsf(sp.csr_matrix(a), w, max_pops=12,
                                       batch_pops=4)
            assert got == _reference_single(agent, layers, (a, w), rng, 12,
                                            4)
            assert agent._rng.bit_generator.state == rng.bit_generator.state
    else:
        got = _program_search(agent, graphs, 12, 4, group)
        assert got == _reference_search(agent, layers, graphs, 12, 4, group)
    assert DiverAgent.bsf_fallback_states == fallback    # float32 weights
    assert DiverAgent.bsf_children > children


def test_published_checkpoint_matches_the_reference():
    agent = _agent(PUBLISHED, seed=11)
    assert agent.load(CKPT)
    graphs = _graphs(6, 2, 60, 60, p=0.1)
    seen = []
    real = agent._eval_heads_resident

    def observed(*args):
        out = real(*args)
        seen.append((np.asarray(args[1]), np.asarray(args[2]), out[1]))
        return out
    agent._eval_heads_resident = observed
    got = _program_search(agent, graphs, 8, 8, 2)
    calls = []
    layers = checkpoint.load_layers(f"{CKPT}/params.npz", "cpu")
    want = _reference_search(agent, layers, graphs, 8, 8, 2, calls)
    assert got == want
    assert len(seen) == len(calls) == 2
    for (gidx, masks, probs), (rgidx, rmasks, rprobs, _) in zip(seen,
                                                                  calls):
        assert np.array_equal(gidx, rgidx) and np.array_equal(masks, rmasks)
        for p, rp in zip(probs, rprobs):
            np.testing.assert_allclose(p, rp[: p.shape[0]], rtol=1e-5,
                                       atol=1e-7)


def _spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("distgcn."):
            start = ev.start_ns()
            spans.append((ev.name(), start, start + ev.duration_ns()))
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _counted(agent):
    """Wraps `_bsf_eval`: the Q of each device call."""
    qs = []
    real = agent._bsf_eval

    def counted(adjs, gidx, wts, mask):
        qs.append(int(wts.shape[0]))
        return real(adjs, gidx, wts, mask)
    agent._bsf_eval = counted
    return qs


@pytest.mark.parametrize("entry", ["many", "single"])
def test_spans_nest_and_counters_count(entry, monkeypatch):
    agent = _agent(SMALL)
    graphs = _graphs(9, 4, 12, 30)
    qs = _counted(agent)
    pushes = []
    real_push = agents_extra.heapq.heappush

    def push(heap, item):
        pushes.append(item)
        real_push(heap, item)
    monkeypatch.setattr(agents_extra.heapq, "heappush", push)
    before = (DiverAgent.bsf_calls, DiverAgent.bsf_states,
              DiverAgent.bsf_fallback_states, DiverAgent.bsf_children)
    if entry == "many":
        # float32 weights: every state through the array passes
        _, spans = _spans(lambda: _program_search(agent, graphs, 8, 4, 2))
        fallback = 0
    else:
        # float64 weights: every state head by head
        a, w = graphs[0]
        w = np.random.default_rng(9).random(w.size)
        _, spans = _spans(lambda: agent.solve_mwis_bsf(
            sp.csr_matrix(a), w, max_pops=8, batch_pops=4))
        fallback = sum(qs)
    assert DiverAgent.bsf_calls - before[0] == len(qs) > 0
    assert DiverAgent.bsf_states - before[1] == sum(qs)
    assert DiverAgent.bsf_fallback_states - before[2] == fallback
    assert DiverAgent.bsf_children - before[3] == len(pushes) > 0
    names = [s[0] for s in spans]
    assert names.count("distgcn.episode") == 1
    episode = spans[names.index("distgcn.episode")]
    assert all(_inside(s, episode) for s in spans)
    slots = [s for s in spans if s[0] == "distgcn.slot"]
    assert names.count("distgcn.gcn") == len(qs)
    assert names.count("distgcn.lgs") == 2 * len(qs)
    assert names.count("distgcn.sync") == 2 * len(qs)
    for s in spans:
        if s[0] in ("distgcn.gcn", "distgcn.lgs"):
            assert sum(_inside(s, slot) for slot in slots) == 1
    lgs = [s for s in spans if s[0] == "distgcn.lgs"]
    for s in (s for s in spans if s[0] == "distgcn.sync"):
        assert sum(_inside(s, outer) for outer in lgs) == 1
    gcn = [s for s in spans if s[0] == "distgcn.gcn"]
    for g, first_lgs in zip(gcn, lgs[::2]):
        assert g[2] <= first_lgs[1]


@pytest.mark.parametrize("entry", ["single", "many"])
def test_a_passed_deadline_stops_before_the_first_step(entry):
    """Both entries check the deadline before each step: one already
    passed makes no device call, every joined search returns its empty
    best and an instance not yet joined returns None."""
    agent = _agent(SMALL)
    qs = _counted(agent)
    insts = [(sp.csr_matrix(a), w) for a, w in _graphs(11, 3, 12, 30)]
    if entry == "single":
        got = agent.solve_mwis_bsf(*insts[0], max_pops=8, time_limit=-1.0)
        assert got == (set(), 0.0)
    else:
        got = agent.solve_mwis_bsf_many(insts, max_pops=8, time_limit=-1.0,
                                        group=2)
        assert got == [(set(), 0.0), (set(), 0.0), None]
    assert qs == []


def test_results_are_bit_equal_with_the_profiler_on_and_off():
    graphs = _graphs(10, 4, 12, 30)
    off = _program_search(_agent(SMALL), graphs, 8, 4, 2)
    on, spans = _spans(lambda: _program_search(_agent(SMALL), graphs, 8, 4,
                                               2))
    assert spans and on == off
    a, w = graphs[1]
    off = _agent(SMALL).solve_mwis_bsf(sp.csr_matrix(a), w, max_pops=8)
    on, spans = _spans(lambda: _agent(SMALL).solve_mwis_bsf(
        sp.csr_matrix(a), w, max_pops=8))
    assert spans and on == off
