"""The benchmark loads neither JAX nor the JAX package (`distgcn_tpu`,
compared by whole top-level name: the port's name begins with it), the
reference imports nothing of the port, and nothing the benchmark runs
reads the JAX package's bench files."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from bench_h100.harness import FORBIDDEN
from bench_h100.tests import tiny

BENCH = tiny.BENCH
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "bench_h100",
                                          "contextlib", "dataclasses",
                                          "functools", "typing", "pathlib",
                                          "numpy", "scipy", "torch"), \
                (path, name)
            if name.startswith("bench_h100"):
                assert name.startswith("bench_h100.reference"), (path, name)


def test_no_source_names_the_jax_bench_files():
    for path in SOURCES + sorted(BENCH.rglob("*.json")):
        text = path.read_text()
        for banned in ("BENCH_r01", "MULTICHIP_r01", "BASELINE.json",
                       "bench.py\""):
            assert banned not in text, (path, banned)


_PROBE = """
import json, sys
from pathlib import Path
from bench_h100 import harness
from bench_h100.tests import tiny
root = tiny.make_root(Path(sys.argv[1]))
for cell in tiny.CELLS:
    out = harness.run_cell(root, cell, 5, 0.02, False, device="cpu")
    assert out["correct"], out
spec = json.loads((root / "BENCHMARK.json").read_text())
for m in spec["per_layer"]:
    harness.load_module(root, "metrics", m["name"])
import bench_h100.calibrate, bench_h100.run
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(tmp_path)],
                         cwd=tiny.REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_command_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder:
    the run exits non-zero and prints no result."""
    import shutil
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                          "dense_dqn_b512", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
