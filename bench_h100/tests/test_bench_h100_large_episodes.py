"""The large gdpg episode cell (`drivers/large_episodes.py`) at a tiny size
on the CPU, added as new files only: a sound run is correct; a run with a
fault planted in the port is not (an episode that returns its start
state, half of the links left out of every schedule, a mean utility
altered where it is produced, a final queue that is no whole number); and
the control, the reference with fp8 activations in the program's place,
is not correct either."""

from __future__ import annotations

import pytest

from bench_h100 import harness
from bench_h100.tests import tiny_more
from distgcn_tpu_torch import large as port_large

SEED = 3_000_000_019
CELL = "tiny_large_gdpg"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_more.make_root(tmp_path_factory.mktemp("episodes"),
                               {CELL: tiny_more.CELLS[CELL]})


def _run(root):
    return harness.run_cell(root, CELL, SEED, 0.05, False, device="cpu")


def test_the_cell_added_as_new_files_runs(root):
    out = _run(root)
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"slot_ms", "setup_s"}
    assert out["attempted"] % 12 == 0 and out["failed"] == 0


def _wrap_episode(monkeypatch, alter):
    make = port_large.make_large_closed_loop

    def broken_make(*a, **k):
        episode = make(*a, **k)

        def broken(plist, queue, gen):
            return alter(queue, *episode(plist, queue, gen))
        return broken
    monkeypatch.setattr(port_large, "make_large_closed_loop", broken_make)


def _state_unchanged(monkeypatch):
    _wrap_episode(monkeypatch, lambda q0, q, met: (q0, met))


def _utility_altered(monkeypatch):
    _wrap_episode(monkeypatch, lambda q0, q, met: (
        q, dict(met, avg_utility=met["avg_utility"] * 1.02)))


def _queue_not_whole(monkeypatch):
    def alter(q0, q, met):
        q = q.clone()
        q[7] += 0.5                    # one link's queue off by a half
        return q, met
    _wrap_episode(monkeypatch, alter)


def _half_links(monkeypatch):
    lgs = port_large.bsr_lgs

    def broken(graph, w, mask, *a):
        sel, util, rounds = lgs(graph, w, mask, *a)
        sel = sel.clone()
        sel[sel.shape[0] // 2:] = 0
        return sel, util, rounds
    monkeypatch.setattr(port_large, "bsr_lgs", broken)


FAULTS = {"state_unchanged": _state_unchanged,
          "utility_altered": _utility_altered,
          "queue_not_whole": _queue_not_whole,
          "half_left_out": _half_links}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_is_not_correct(root, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(root)
    assert out["correct"] is False, out["check"]


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    """The tiny cell at the control's size (as the large slot cell's)."""
    return tiny_more.make_root(tmp_path_factory.mktemp("episodes_control"),
                               {CELL: tiny_more.CELLS[CELL]},
                               sizes={CELL: {"n": 2048}})


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(control_root, seed):
    c = harness.find_cell(control_root, CELL)
    driver = harness.load_module(control_root, "drivers",
                                 c.traffic["driver"])
    got = driver.control(c, seed, "cpu")
    checks = [(name, got[name], limit) for name, limit in c.limits.items()]
    assert harness.verdict(checks) is False, got
