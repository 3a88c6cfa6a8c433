"""The diver cell (`drivers/diver_search.py`) at a tiny size on the CPU,
added as new files only: a sound run is correct, and a run with a fault
planted in the port is not (a head left out of the guided weights, TF32
switched on inside the device call, a conflict forced into a returned
set); the control, the reference with TF32 operands in the program's
place, is not correct either. The cell's readers on a hand-made trace,
and None where the trace holds no span or counter of the program."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import tiny_more
from bench_h100.tests.test_bench_h100_faults import (  # noqa: F401
    _products_heed_tf32, tf32_flags)
from bench_h100.trace import Trace
from distgcn_tpu_torch import agents_extra
from distgcn_tpu_torch.agents_extra import DiverAgent

SEED = 3_000_000_019
CELL = "tiny_diver"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_more.make_root(tmp_path_factory.mktemp("diver"),
                               {CELL: tiny_more.CELLS[CELL]})


def _run(root):
    return harness.run_cell(root, CELL, SEED, 0.05, False, device="cpu")


def test_the_cell_added_as_new_files_runs(root):
    out = _run(root)
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"decisions_per_s", "setup_s"}
    assert set(out["check"]) == {"graphs_off", "probs_err",
                                 "completions_off", "conflicts",
                                 "util_arith_off"}
    assert out["attempted"] >= 3 and out["failed"] == 0


def _head_dropped(monkeypatch):
    lgs = agents_extra.batched_lgs_multi

    def broken(adj, wts, mask, *a):
        wts = wts.clone()
        wts[:, 0] = 0.0                 # head 0's completion left unguided
        return lgs(adj, wts, mask, *a)
    monkeypatch.setattr(agents_extra, "batched_lgs_multi", broken)


def _tf32_on(monkeypatch):
    _products_heed_tf32(monkeypatch)
    real = DiverAgent._bsf_eval

    def broken(self, *a):
        torch.backends.cuda.matmul.allow_tf32 = True
        return real(self, *a)
    monkeypatch.setattr(DiverAgent, "_bsf_eval", broken)


def _conflict_forced(monkeypatch):
    real = DiverAgent.solve_mwis_bsf_many

    def broken(self, insts, *a, **k):
        out = real(self, insts, *a, **k)
        links, util = out[0]
        adj = insts[0][0]
        v = next(iter(links))
        u = int(adj.indices[adj.indptr[v]])        # a neighbour of v
        out[0] = (links | {u}, util + float(insts[0][1][u]))
        return out
    monkeypatch.setattr(DiverAgent, "solve_mwis_bsf_many", broken)


FAULTS = {"head_dropped": _head_dropped, "tf32_on": _tf32_on,
          "conflict_forced": _conflict_forced}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_is_not_correct(root, fault, monkeypatch, tf32_flags):
    FAULTS[fault](monkeypatch)
    out = _run(root)
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(root, seed):
    c = harness.find_cell(root, CELL)
    driver = harness.load_module(root, "drivers", c.traffic["driver"])
    got = driver.control(c, seed, "cpu")
    checks = [(name, got[name], limit) for name, limit in c.limits.items()]
    assert harness.verdict(checks) is False, got


# one group of two device calls: the card busy 1050 ns of an untraced
# 2000 ns a group; its idle gaps lie in the GCN (300-500), the search
# (600-700, 1100-1700, 1900-1950) and a read-back of the LGS (900-1000)
DEVICE = [(100, 300), (500, 600), (700, 900), (1000, 1100), (1700, 1900),
          (1950, 2150), (2150, 2200)]
IDLE = 100.0 * (1 - 1050 / 2000)


def _host(spans=True):
    host = [("aten::mm", 0, 50), ("cudaLaunchKernel", 0, 2300)]
    if spans:
        host += [("distgcn.episode", 50, 2300), ("distgcn.slot", 60, 1200),
                 ("distgcn.gcn", 60, 450), ("distgcn.lgs", 450, 500),
                 ("distgcn.lgs", 900, 1150), ("distgcn.sync", 900, 1050),
                 ("distgcn.sync", 1050, 1150), ("distgcn.slot", 1200, 2250),
                 ("distgcn.gcn", 1200, 1300)]
    return host


def _view(spans=True, counters=True):
    trace = Trace(device=[("lgs_kernel<4>", s, e, True) for s, e in DEVICE],
                  host=_host(spans), window_s=2.3e-6, units=1,
                  counters={"lgs_launches": 2, "bsf_calls": 2,
                            "bsf_states": 9} if counters
                  else {"lgs_launches": 2})
    return SimpleNamespace(trace=trace, cell=None, work={
        "timed_s": 2e-6 * 50, "timed_units": 50,
        "kernels": {"lgs_multi": {"match": "lgs_kernel",
                                  "bound_s": 10e-9}}})


READERS = {"device_idle_pct.diver": IDLE,
           "idle_pct_gcn.diver": IDLE * 200 / 1050,
           "idle_pct_lgs.diver": IDLE * 100 / 1050,
           "idle_pct_search.diver": IDLE * 750 / 1050,
           "states_per_call.diver": 4.5,
           "lgs_multi_roofline_pct": 100.0 * 10e-9 * 7 / 1050e-9}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_on_a_hand_made_trace(metric):
    read = harness.load_module(tiny_more.REPO, "metrics", metric).read
    assert read(_view()) == pytest.approx(READERS[metric])
    if metric.startswith("idle_pct_") or metric.startswith("states_"):
        assert read(_view(spans=False, counters=False)) is None
