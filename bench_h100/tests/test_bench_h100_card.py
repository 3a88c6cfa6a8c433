"""On the card (marker ``cuda``; skipped without one): a tiny cell of each
driver through the whole run with its trace, and each real cell's
command for a short window.

    python -m pytest bench_h100/tests/test_bench_h100_card.py -m cuda -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import tiny

SPEC = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_tiny_cell_traced_on_the_card(card, root, cell):
    out = harness.run_cell(root, cell, 17, 0.5, True, device="cuda")
    assert out["correct"] is True, out["check"]
    assert out["device"]["busy_s"] > 0
    assert out["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_command_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                          cell, "--seed", "2147483659", "--seconds", "2",
                          "--trace", "0"], cwd=tiny.REPO, capture_output=True,
                         text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["check"]
