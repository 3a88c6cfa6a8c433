"""The port's program spans (`utils.profiling.span`) in its slot loops
(dense, large, and the product-graph and sequential multi-channel loops):
none without a profiler, results bit-equal with one, spans nested as
documented, and one ``distgcn.sync`` a `large.bsr_lgs` read of its
rounds' counts."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from distgcn_tpu_torch import large
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.models.gcn import make_model_from_config
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.utils import profiling
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.serialization import load_params

CKPT = "model/result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn/params.npz"
SLOTS = 4


def _dense_episode(feature_mode="dqn"):
    """A closure running one tiny dense episode from empty queues."""
    rng = np.random.default_rng(3)
    adjs = []
    for n in (20, 28, 31):
        a = np.triu((rng.random((n, n)) < 0.15).astype(np.float32), 1)
        adjs.append(sp.csr_matrix(a + a.T))
    gb = GraphBatch.from_scipy(adjs, [np.ones(a.shape[0]) for a in adjs],
                               pad_to=32, device="cpu")
    cfg = Config(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
                 max_degree=1, predict="mwis", pad_to=32)
    model = make_model_from_config(cfg, "gcn_dqn", device="cpu")
    run = device_sim.make_closed_loop(model, cfg, timeslots=SLOTS, load=0.9,
                                      feature_mode=feature_mode)
    return lambda: run(gb.adj, gb.mask, torch.zeros(gb.wts.shape),
                       torch.Generator().manual_seed(5))


def _large_slot():
    """A closure running one slot of the large loop's dqn mode (the
    benchmark's) on a small geometric graph, queues carried over calls."""
    adj, _, _ = large.geometric_conflict_graph(300, avg_degree=8.0, seed=7)
    g = large.build_large_graph(adj, block_size=128, use_bsr=True,
                                device="cpu")
    plist = large.params_to_list(load_params(CKPT), device="cpu")
    run = large.make_large_closed_loop(g, timeslots=1, load=0.9,
                                       feature_mode="dqn")
    state = {"q": torch.zeros(g.n_pad),
             "gen": torch.Generator().manual_seed(9)}

    def slot():
        state["q"], met = run(plist, state["q"], state["gen"])
        return state["q"], met
    return slot


def _spans(prof):
    """(name, start ns, end ns) of the profile's program spans, each a
    host operator (no user annotation for the device's timeline to
    mirror)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("distgcn."):
            assert ev.device_type() == torch.autograd.DeviceType.CPU
            assert str(ev.activity_type()) != "user_annotation"
            start = ev.start_ns()
            out.append((ev.name(), start, start + ev.duration_ns()))
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.mark.parametrize("loop", ["dense", "large"])
def test_no_record_function_without_a_profiler(monkeypatch, loop):
    calls = []

    def counting(real):
        def make(name, *args, **kwargs):
            calls.append(name)
            return real(name, *args, **kwargs)
        return make

    for mod, attr in ((torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (torch._C._profiler, "_RecordFunctionFast")):
        monkeypatch.setattr(mod, attr, counting(getattr(mod, attr)))
    fn = _dense_episode() if loop == "dense" else _large_slot()
    fn()
    assert calls == []
    _profiled(fn)                  # the count sees the spans it guards
    assert "distgcn.slot" in calls and "distgcn.lgs" in calls


def test_span_is_one_shared_no_op_until_a_profiler_records():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("distgcn.slot")
    assert off is profiling.span("distgcn.gcn")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        on = profiling.span("distgcn.slot")
        assert on is not off
        assert isinstance(on, torch._C._profiler._RecordFunctionFast)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("distgcn.slot") is off


def _bits(out):
    q, met = out
    return [q.numpy().tobytes()] + [met[k].numpy().tobytes()
                                    for k in sorted(met)]


@pytest.mark.parametrize("loop", ["dense_dqn", "dense_gdpg", "large"])
def test_results_are_bit_equal_with_the_profiler_on_and_off(loop):
    def make():
        if loop == "large":
            return _large_slot()
        return _dense_episode(loop.split("_")[1])
    off, on = make(), make()
    for _ in range(2):                 # the large loop carries its queues
        want = _bits(off())
        got, spans = _profiled(on)
        assert spans and _bits(got) == want


def test_dense_spans_nest_slot_gcn_lgs_in_the_episode():
    _, spans = _profiled(_dense_episode("dqn"))
    names = [s[0] for s in spans]
    assert names.count("distgcn.episode") == 1
    assert names.count("distgcn.slot") == SLOTS
    episode = spans[names.index("distgcn.episode")]
    slots = [s for s in spans if s[0] == "distgcn.slot"]
    for s in spans:
        assert _inside(s, episode)
    for name in ("distgcn.gcn", "distgcn.lgs"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == SLOTS
        for slot in slots:
            assert sum(_inside(s, slot) for s in inner) == 1
    assert "distgcn.sync" not in names          # B1 syncs nothing


def test_large_slot_spans_nest_and_count_one_sync_a_round(monkeypatch):
    """One ``distgcn.sync`` a read of the counts: a batch of rounds (the
    graph's last rounds + 1 after the first solve), not a round."""
    rounds, reads = [], []
    real = large.bsr_lgs

    def counted(*args, **kwargs):
        r0 = real.reads
        out = real(*args, **kwargs)
        rounds.append(int(out[2]))
        reads.append(real.reads - r0)
        return out

    monkeypatch.setattr(large, "bsr_lgs", counted)
    slot = _large_slot()
    for _ in range(3):
        rounds.clear()
        reads.clear()
        _, spans = _profiled(slot)
        names = [s[0] for s in spans]
        assert len(rounds) == 1 and rounds[0] >= 1
        assert 1 <= reads[0] <= rounds[0]
        assert names.count("distgcn.sync") == reads[0]
        assert names.count("distgcn.slot") == 1
        assert names.count("distgcn.gcn") == names.count("distgcn.lgs") == 1
        slot_span = spans[names.index("distgcn.slot")]
        lgs_span = spans[names.index("distgcn.lgs")]
        gcn_span = spans[names.index("distgcn.gcn")]
        assert _inside(gcn_span, slot_span) and _inside(lgs_span, slot_span)
        assert gcn_span[2] <= lgs_span[1]
        for s in spans:
            if s[0] == "distgcn.sync":
                assert _inside(s, lgs_span)


def _multichannel_episode(loop):
    """A closure running one tiny 3-channel episode from empty queues: the
    product-graph loop (dqn features, the GCN every slot) or the
    sequential loop (DGCN-LGS-Seq)."""
    from distgcn_tpu_torch.data import wireless

    rng = np.random.default_rng(4)
    n_ch, nfp = 3, 32
    ch = np.zeros((3, n_ch, nfp, nfp), np.float32)
    gk = np.zeros((3, n_ch * nfp, n_ch * nfp), np.float32)
    mask = np.zeros((3, nfp), bool)
    for i, n in enumerate((20, 28, 31)):
        chans = []
        for c in range(n_ch):
            a = np.triu((rng.random((n, n)) < 0.15).astype(np.float32), 1)
            chans.append(sp.csr_matrix(a + a.T))
            ch[i, c, :n, :n] = (a + a.T)
        gk[i] = wireless.pad_product_graph(
            wireless.multichannel_conflict_graph(chans)[1], n, n_ch, nfp)
        mask[i, :n] = True
    cfg = Config(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
                 max_degree=1, predict="mwis", pad_to=nfp)
    model = make_model_from_config(cfg, "gcn_dqn", device="cpu")
    if loop == "mc":
        run = device_sim.make_closed_loop_mc(model, cfg, SLOTS, n_ch,
                                             load=0.9, feature_mode="dqn")
        graphs = torch.from_numpy(gk)
    else:
        run = device_sim.make_closed_loop_seq(model, cfg, SLOTS, n_ch,
                                              load=0.6)
        graphs = torch.from_numpy(ch)
    return lambda: run(graphs, torch.from_numpy(mask), torch.zeros(mask.shape),
                       torch.Generator().manual_seed(6))


@pytest.mark.parametrize("loop,per_slot", [("mc", 1), ("seq", 3)])
def test_multichannel_spans_nest_in_each_slot(loop, per_slot):
    """The product-graph and sequential loops carry the dense loop's spans:
    one episode, a slot span each slot, and in each slot a GCN and an LGS
    span a launch (one on the product graph, one a channel in the
    sequential loop); results bit-equal with the profiler on and off."""
    want = _bits(_multichannel_episode(loop)())
    got, spans = _profiled(_multichannel_episode(loop))
    assert _bits(got) == want
    names = [s[0] for s in spans]
    assert names.count("distgcn.episode") == 1
    episode = spans[names.index("distgcn.episode")]
    slots = [s for s in spans if s[0] == "distgcn.slot"]
    assert len(slots) == SLOTS
    for s in spans:
        assert _inside(s, episode)
    for name in ("distgcn.gcn", "distgcn.lgs"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == SLOTS * per_slot
        for slot in slots:
            assert sum(_inside(s, slot) for s in inner) == per_slot
