"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a tiny size (`tiny.make_root`), with one fault planted in
the port: a step that returns its state unchanged; half of the batch (on
the large path, half of the links) left out of the schedule; an answer
altered where it is produced; TF32 switched on inside the step. The cells
run on one card, so there is no exchange between cards to leave out. The
same runs unbroken come out correct. The control, the reference one
precision step below the configuration's in the program's place, comes
out not correct too.
"""

from __future__ import annotations

import json

import pytest
import torch

from bench_h100 import calibrate, harness
from bench_h100.reference.precision import round_significand
from bench_h100.tests import tiny
from distgcn_tpu_torch import large as port_large
from distgcn_tpu_torch.sim import device_sim

SEED = 3_000_000_019


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _run(root, cell):
    return harness.run_cell(root, cell, SEED, 0.05, False, device="cpu")


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_sound_runs_are_correct(root, cell):
    assert _run(root, cell)["correct"] is True


def _dense_state_unchanged(monkeypatch):
    slot = device_sim._slot

    def broken(scores, wt_sel, supports, adjb, mask, queue, *rest):
        return (queue,) + slot(scores, wt_sel, supports, adjb, mask, queue,
                               *rest)[1:]
    monkeypatch.setattr(device_sim, "_slot", broken)


def _dense_half_batch(monkeypatch):
    lgs = device_sim.batched_lgs

    def broken(adjb, w, mask, *a):
        sel, util, rounds = lgs(adjb, w, mask, *a)
        sel = sel.clone()
        sel[sel.shape[0] // 2:] = 0
        return sel, util, rounds
    monkeypatch.setattr(device_sim, "batched_lgs", broken)


def _dense_answer_altered(monkeypatch):
    lgs = device_sim.batched_lgs

    def broken(adjb, w, mask, *a):
        sel, util, rounds = lgs(adjb, w, mask, *a)
        sel = sel.clone()
        first = int(torch.nonzero(sel[0] == 1)[0, 0])
        sel[0, first] = 0                      # one link of graph 0 dropped
        return sel, util, rounds
    monkeypatch.setattr(device_sim, "batched_lgs", broken)


def _wrap_large_step(monkeypatch, alter):
    make = port_large.make_large_closed_loop

    def broken_make(*a, **k):
        step = make(*a, **k)

        def broken(plist, queue, gen):
            q, met = step(plist, queue, gen)
            return alter(queue, q), met
        return broken
    monkeypatch.setattr(port_large, "make_large_closed_loop", broken_make)


def _large_state_unchanged(monkeypatch):
    _wrap_large_step(monkeypatch, lambda before, after: before)


def _large_answer_altered(monkeypatch):
    def alter(before, after):
        after = after.clone()
        after[7] += 1.0                        # one link's queue off by one
        return after
    _wrap_large_step(monkeypatch, alter)


def _large_half_links(monkeypatch):
    lgs = port_large.bsr_lgs

    def broken(graph, w, mask, *a):
        sel, util, rounds = lgs(graph, w, mask, *a)
        sel = sel.clone()
        sel[sel.shape[0] // 2:] = 0
        return sel, util, rounds
    monkeypatch.setattr(port_large, "bsr_lgs", broken)


FAULTS = {
    "state_unchanged": {"dense": _dense_state_unchanged,
                        "large": _large_state_unchanged},
    "half_left_out": {"dense": _dense_half_batch,
                      "large": _large_half_links},
    "answer_altered": {"dense": _dense_answer_altered,
                       "large": _large_answer_altered},
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_a_fault_is_not_correct(root, cell, fault, monkeypatch):
    FAULTS[fault]["dense" if "dense" in cell else "large"](monkeypatch)
    out = _run(root, cell)
    assert out["correct"] is False, out["check"]


# sizes at which the control's lower precision shows on every seed tried
CONTROL_SIZES = {
    "tiny_dense_dqn": {"batch": 16, "n_lo": 40, "n_hi": 64, "pad_to": 64},
    "tiny_dense_gdpg": {"batch": 16, "n_lo": 40, "n_hi": 64, "pad_to": 64},
    "tiny_large": {"n": 2048},
    "tiny_large_weighted": {"n": 4096},
}
CONTROL_TRAFFIC = {"timeslots": 40, "check_episodes": 3, "check_slots": 16}


@pytest.fixture
def tf32_flags():
    """The process's TF32 flags, put back after the test."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cuda.matmul.allow_tf32 = saved[1]
    torch.backends.cudnn.allow_tf32 = saved[2]


def _products_heed_tf32(monkeypatch):
    """On the CPU a float32 matrix product ignores the TF32 flag; here it
    heeds it as cuBLAS does on the card: with the flag on, both float32
    operands are rounded to TF32's ten significand bits."""
    def rounded(a, b):
        if torch.backends.cuda.matmul.allow_tf32 \
                and a.dtype == b.dtype == torch.float32:
            return round_significand(a, 10), round_significand(b, 10)
        return a, b
    matmul, bmm, dunder = torch.matmul, torch.bmm, torch.Tensor.__matmul__
    monkeypatch.setattr(torch, "matmul",
                        lambda a, b, **k: matmul(*rounded(a, b), **k))
    monkeypatch.setattr(torch, "bmm", lambda a, b, **k: bmm(*rounded(a, b),
                                                              **k))
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        lambda a, b: dunder(*rounded(a, b)))


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    """The tiny cells at the control's sizes."""
    root = tiny.make_root(tmp_path_factory.mktemp("control"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    configs = {c["name"]: root / c["file"] for c in spec["configs"]}
    for w in spec["workloads"]:
        path = configs[w["config"]]
        cfg = json.loads(path.read_text())
        cfg["graphs" if "graphs" in cfg else "graph"].update(
            CONTROL_SIZES[w["name"]])
        path.write_text(json.dumps(cfg))
        path = root / "bench_h100" / "traffic" / f"{w['traffic']}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **CONTROL_TRAFFIC)))
    return root


# the cells whose stated precision is float32 matrix products; the fused
# route's products are its own kernel's, which no TF32 flag reaches
TF32_CELLS = ["tiny_dense_dqn", "tiny_dense_gdpg", "tiny_large_weighted"]


@pytest.mark.parametrize("cell", TF32_CELLS)
def test_tf32_in_the_step_is_not_correct(control_root, cell, monkeypatch,
                                         tf32_flags):
    """The reference keeps full float32 whatever the program switched on
    in the process, so a step that turns TF32 on is caught."""
    _products_heed_tf32(monkeypatch)
    assert harness.run_cell(control_root, cell, SEED, 0.05, False,
                            device="cpu")["correct"] is True
    calibrate.tf32_in_step(monkeypatch.setattr)
    out = harness.run_cell(control_root, cell, SEED, 0.05, False,
                           device="cpu")
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_the_control_is_not_correct(control_root, cell, seed):
    c = harness.find_cell(control_root, cell)
    driver = harness.load_module(control_root, "drivers",
                                 c.traffic["driver"])
    got = driver.control(c, seed, "cpu")
    checks = [(name, got[name], limit) for name, limit in c.limits.items()]
    assert harness.verdict(checks) is False, got
