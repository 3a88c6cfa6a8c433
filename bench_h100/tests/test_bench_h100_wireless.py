"""The two wireless cells at a tiny size on the CPU, built from new files
only (`tiny_wireless.make_root`): each runs end to end and comes out
correct, a traced run reads every per-layer metric the cells list, and
runs with a fault planted in the port come out not correct: the
sequential loop scoring each channel on its whole channel graph (the
published algorithm deletes the zero-utility links first), the baseline
left out of the single-channel loop, a queue left unchanged. The control
(the reference at TF32) comes out not correct too."""

from __future__ import annotations

import json

import pytest
import torch

from bench_h100 import harness, spans
from bench_h100.tests import tiny_wireless
from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.sim import device_sim

SEED = 4_294_967_311
NCH1, SEQ3 = list(tiny_wireless.CELLS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_wireless.make_root(tmp_path_factory.mktemp("tiny_wireless"),
                                   keys={SEQ3: {"timeslots": 30}})


def _run(root, cell, trace=False, seed=SEED):
    return harness.run_cell(root, cell, seed, 0.05, trace, device="cpu")


@pytest.mark.parametrize("cell", [NCH1, SEQ3])
def test_a_wireless_cell_added_as_new_files_runs(root, cell):
    out = _run(root, cell)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"decisions_per_s", "setup_s"}
    assert out["attempted"] % (2 * 3) == 0
    assert list(out)[-1] == "check"


def test_traced_runs_read_the_wireless_metrics(root, monkeypatch):
    """On the CPU the profiler sees no device (and the trace's synchronise
    is a no-op here), so only the counted FLOPs give a reading,
    `mfu.wireless`. The spans of both loops are recorded: one episode
    span a load, one slot span a slot, in the sequential loop a GCN and an
    LGS span a channel, and in the single-channel loop an LGS span each
    for the schedule and the baseline."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    seen = {}
    real = spans.idle_ns

    def keep(trace):
        names = [n for n, *_ in trace.host if n.startswith("distgcn.")]
        seen.setdefault("names", []).append(names)
        return real(trace)
    monkeypatch.setattr(spans, "idle_ns", keep)
    for cell, slots, per_slot in ((NCH1, 10, 2), (SEQ3, 30, 3)):
        out = _run(root, cell, trace=True)
        assert out["correct"] is True
        assert out["metrics"]["mfu.wireless"]["value"] > 0
        names = seen["names"][-1]
        assert names.count("distgcn.episode") == 2
        assert names.count("distgcn.slot") == 2 * slots
        assert names.count("distgcn.lgs") == 2 * slots * per_slot
        gcn = names.count("distgcn.gcn")
        # one channel: the hoisted forward an episode, then the product
        # act x w a slot; three: a subgraph's supports and forward a channel
        assert gcn == (2 + 2 * slots if cell == NCH1 else 2 * slots * 3)


WIRELESS_READERS = {"idle_pct_gcn.wireless": 50.0 * 80 / 500,
                    "idle_pct_lgs.wireless": 50.0 * 120 / 500,
                    "idle_pct_loop.wireless": 50.0 * 200 / 500,
                    "device_idle_pct.wireless": 50.0}


@pytest.mark.parametrize("metric", sorted(WIRELESS_READERS))
def test_span_readers_on_a_hand_made_trace(metric):
    """The readers on `test_bench_h100_spans`'s hand-made trace: the three
    stages and the 10 points outside any span add up to the idle share."""
    from bench_h100.tests.test_bench_h100_spans import _host, _run as trace
    read = harness.load_module(tiny_wireless.REPO, "metrics", metric).read
    assert read(trace(_host())) == pytest.approx(WIRELESS_READERS[metric])
    parts = sum(v for k, v in WIRELESS_READERS.items()
                if k.startswith("idle_pct"))
    assert parts + 10.0 == pytest.approx(
        WIRELESS_READERS["device_idle_pct.wireless"])


def _whole_graph_scoring(monkeypatch):
    """The sequential loop's scoring before the fix: supports over the
    whole channel graph, whatever the utilities."""
    monkeypatch.setattr(
        device_sim, "subgraph_supports",
        lambda adj, keep, k, dtype: prep.masked_simple_polynomials_dense(
            adj, torch.ones_like(keep), k).to(dtype))


def _no_baseline(monkeypatch):
    make = device_sim.make_closed_loop

    def broken(*a, **k):
        k["with_baseline"] = False
        return make(*a, **k)
    monkeypatch.setattr(device_sim, "make_closed_loop", broken)


def _seq_queue_kept(monkeypatch):
    """One network's queue left as it was before the slot's departures."""
    make = device_sim.make_closed_loop_seq

    def broken(*a, **k):
        run = make(*a, **k)

        def wrapped(adj_ch, link_mask, queue0, generator):
            q, met = run(adj_ch, link_mask, queue0, generator)
            q = q.clone()
            q[0] += 1.0
            return q, met
        return wrapped
    monkeypatch.setattr(device_sim, "make_closed_loop_seq", broken)


@pytest.mark.parametrize("cell,plant", [
    (SEQ3, _whole_graph_scoring), (NCH1, _no_baseline),
    (SEQ3, _seq_queue_kept)])
def test_planted_faults_fail_graphs_off(root, monkeypatch, cell, plant):
    plant(monkeypatch)
    out = _run(root, cell)
    assert out["correct"] is False
    assert out["check"]["graphs_off"]["value"] > 0


@pytest.mark.parametrize("cell", [NCH1, SEQ3])
def test_control_fails(root, cell):
    c = harness.find_cell(root, cell)
    driver = harness.load_module(root, "drivers", c.traffic["driver"])
    got = driver.control(c, SEED, "cpu")
    assert got["graphs_off"] > c.limits["graphs_off"]


def test_a_port_without_the_routing_fails_at_once(root, monkeypatch):
    """A program without `wireless_sim.device_loop` (a port older than
    the shared routing) stops before any set-up."""
    from distgcn_tpu_torch.cli import wireless_sim
    monkeypatch.delattr(wireless_sim, "device_loop")
    with pytest.raises(ImportError):
        _run(root, NCH1)


def test_the_spec_lists_the_wireless_cells_and_metrics():
    spec = json.loads((tiny_wireless.REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    for name in tiny_wireless.KIND.values():
        assert cells[name]["config"] == "ergdpg2_l20c32_paper20"
        assert cells[name]["chips"] == 1
    wireless = [m for m in spec["per_layer"] if m["name"].endswith(
        ".wireless")]
    assert len(wireless) == 7
    for m in wireless:
        assert m["workloads"] == list(tiny_wireless.KIND.values())
        assert m["moves"] == "decisions_per_s"
