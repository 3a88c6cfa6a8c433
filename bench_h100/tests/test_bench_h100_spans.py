"""`spans.py` and the six readers of the program's spans on a hand-made
trace: each idle gap goes to its innermost ``distgcn.*`` span, however
many host events lie between, and a trace without program spans reads
None."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_h100 import harness, spans
from bench_h100.tests import tiny
from bench_h100.trace import Trace

# two slots; the card's busy intervals leave nine gaps, and each gap's
# stage is named by the program span around its midpoint
DEVICE = [(0, 10), (30, 150), (190, 520), (580, 820), (900, 1000),
          (1100, 1220), (1240, 1350), (1390, 1920), (1980, 2020),
          (2100, 2300)]
GAPS = {"slot": 20 + 80 + 20 + 80, "gcn": 40 + 40, "lgs": 60 + 60,
        "outside": 100}


def _slot(o):
    return [("distgcn.slot", o, o + 1000), ("distgcn.gcn", o + 100, o + 400),
            ("distgcn.lgs", o + 400, o + 800),
            ("distgcn.sync", o + 500, o + 600),
            ("distgcn.sync", o + 700, o + 790)]


def _host(episode=False):
    host = _slot(0) + _slot(1200)
    # 300 host ops inside slot 2's LGS: its last gap lies past them
    host += [("aten::empty", 1601 + i, 1602 + i) for i in range(300)]
    host += [("aten::item", 520, 590), ("cudaLaunchKernel", 1001, 1002)]
    if episode:
        host.append(("distgcn.episode", 0, 2300))
    return host


def _run(host, timed_units=1000):
    # busy 1800 ns over 2 units: half of an untraced 1800 ns a unit
    trace = Trace(device=[("k", s, e, True) for s, e in DEVICE], host=host,
                  window_s=2.3e-6, units=2)
    return SimpleNamespace(trace=trace, cell=None, work={
        "slots_per_unit": 1, "timed_s": 1.8e-6 * timed_units,
        "timed_units": timed_units})


def test_each_gap_goes_to_its_innermost_program_span():
    by_stage = spans.idle_ns(_run(_host()).trace)
    assert by_stage == GAPS
    s = spans.Spans(_host())
    assert list(s.holding(550)) == ["distgcn.sync", "distgcn.lgs",
                                    "distgcn.slot"]
    assert list(s.holding(2060)) == ["distgcn.slot"]   # 300 ops after
    assert list(s.holding(1050)) == []
    assert s.stage(1950) == "lgs" and s.stage(1050) == "outside"


def test_a_gap_between_slots_is_the_episode_loops_inside_an_episode():
    by_stage = spans.idle_ns(_run(_host(episode=True)).trace)
    assert by_stage == dict(GAPS, slot=GAPS["slot"] + 100, outside=0)


def test_the_breakdowns_walk_stops_short_of_the_slot_span():
    # why the spans are read exactly: `_host_at`'s bounded walk labels
    # slot 2's last gap by the aten op before it, not by its slot
    labels = dict(_run(_host()).trace.breakdown()["idle_gaps"])
    assert labels["after aten::empty"] == pytest.approx(80e-9)


READERS = {"idle_pct_gcn.dense": 50.0 * 80 / 500,
           "idle_pct_loop.dense": 50.0 * 200 / 500,
           "idle_pct_gcn.large": 50.0 * 80 / 500,
           "idle_pct_lgs.large": 50.0 * 120 / 500,
           "idle_pct_slot.large": 50.0 * 200 / 500,
           "host_syncs_per_slot.large": 4 / 2}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_on_a_hand_made_trace(metric):
    read = harness.load_module(tiny.REPO, "metrics", metric).read
    assert read(_run(_host())) == pytest.approx(READERS[metric])
    no_spans = [h for h in _host() if not h[0].startswith("distgcn.")]
    assert read(_run(no_spans)) is None


def test_stages_add_up_to_the_idle_share():
    run = _run(_host())
    parts = [spans.idle_pct(run, st) for st in spans.STAGES]
    assert sum(parts) == pytest.approx(50.0)
    assert parts[-1] == pytest.approx(10.0)          # outside the program


def test_no_sync_spans_read_zero_syncs():
    host = [h for h in _host() if h[0] != "distgcn.sync"]
    assert spans.count_per_slot(_run(host), "distgcn.sync") == 0.0


def test_sync_overhang_on_one_clock():
    trace = _run(_host()).trace
    # sync ends 600, 790, 1800, 1990 lie 220, 30, 120, 30 ns into a
    # device interval
    assert spans.sync_overhang(trace) == 1.0
    assert spans.sync_overhang(trace, slack_ns=100) == 0.5
    assert spans.sync_overhang(_run([]).trace) is None
