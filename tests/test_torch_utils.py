"""Port parity: `utils/profiling.py` (`emv`, `StepTimer`, `trace`) and
`utils/compile_cache.py` (the build root) against the JAX package's
`distgcn_tpu/utils/profiling.py` and the contract of its compile cache.

`emv` and `StepTimer` give JAX's numbers exactly on a fixed sequence: one
fake clock feeds both timers. `trace` writes a Chrome trace file.
`enable_persistent_cache` is run under each of its three settings with
every build root in `tmp_path`; the repository's own ``build/`` is left
as it was.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distgcn_tpu.utils import profiling as jprof
from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.solvers import exact
from distgcn_tpu_torch.utils import compile_cache, profiling
from distgcn_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
SAMPLES = [0.5, 0.25, 1.0, 0.125, 0.0, 3.0, 0.75]


@pytest.mark.parametrize("n", [1, 3, 10])
def test_emv_matches_jax(n):
    got = want = None
    for x in SAMPLES:
        got = profiling.emv(x, got, n)
        want = jprof.emv(x, want, n)
        assert got == want
    assert profiling.emv(2.0, None) == jprof.emv(2.0, None) == 2.0


def _fake_clock(monkeypatch):
    """time.perf_counter steps through the cumulative SAMPLES: every
    second reading ends a step of SAMPLES[i] seconds."""
    ticks = np.concatenate([[0.0], np.repeat(np.cumsum(SAMPLES), 2)])
    it = iter(ticks[:-1].tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def _run(timer):
    for i in range(len(SAMPLES)):
        with timer:
            timer.add(graphs=8 * (i + 1), edges=100 * i)
    return timer


def test_step_timer_matches_jax(monkeypatch):
    _fake_clock(monkeypatch)
    want = _run(jprof.StepTimer("replay"))
    _fake_clock(monkeypatch)
    got = _run(profiling.StepTimer("replay"))
    for f in ("count", "graphs", "edges", "total_s", "ema_s",
              "graphs_per_s", "edges_per_s"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.summary() == want.summary()
    assert got.count == len(SAMPLES)
    assert profiling.StepTimer().summary() == jprof.StepTimer().summary()


def test_step_timer_on_the_cpu_reads_the_host_clock():
    timer = profiling.StepTimer("cpu", device=torch.device("cpu"))
    with timer:
        torch.ones(8).sum()
    assert timer.count == 1 and timer.total_s > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as got:
        assert got == str(logdir)
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    files = list(logdir.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.fixture
def build_dirs(monkeypatch):
    """Each test's changes to the build roots are undone after it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(exact, "BUILD_DIR", exact.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_TEMP", [])


def _repo_libraries():
    root = REPO / "build"
    return sorted((p, p.stat().st_mtime_ns)
                  for sub in ("kernels", "native")
                  for p in (root / sub).glob("*") if p.is_file())


def test_cache_unset_is_the_repository_build(build_dirs, monkeypatch):
    monkeypatch.delenv("DISTGCN_TORCH_CACHE", raising=False)
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
    assert exact.BUILD_DIR == REPO / "build" / "native"
    monkeypatch.setattr(_build, "BUILD_DIR", Path("elsewhere"))
    assert compile_cache.enable_persistent_cache() == str(REPO / "build")
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
    assert exact.BUILD_DIR == REPO / "build" / "native"


def test_cache_path_takes_the_builds(build_dirs, monkeypatch, tmp_path):
    before = _repo_libraries()
    root = tmp_path / "cache"
    monkeypatch.setenv("DISTGCN_TORCH_CACHE", str(root))
    assert compile_cache.enable_persistent_cache() == str(root)
    assert _build.BUILD_DIR == root / "kernels"
    assert exact.BUILD_DIR == root / "native"
    assert _build.library_path("lgs").parent == root / "kernels"
    lib = exact.build()                        # g++ into the cache
    assert lib.parent == root / "native" and lib.is_file()
    assert lib.name == exact.library_path().name
    assert lib.name.startswith("libmwis_exact-")
    assert _repo_libraries() == before


@pytest.mark.parametrize("spec", ["0", "off", "OFF"])
def test_cache_off_is_a_process_temporary(build_dirs, monkeypatch, spec):
    before = _repo_libraries()
    monkeypatch.setenv("DISTGCN_TORCH_CACHE", spec)
    assert compile_cache.enable_persistent_cache() is None
    root = _build.BUILD_DIR.parent
    assert root == exact.BUILD_DIR.parent and root.is_dir()
    assert REPO not in root.parents
    assert compile_cache.enable_persistent_cache() is None
    assert _build.BUILD_DIR.parent == root          # one root per process
    assert _repo_libraries() == before


def test_config_from_args_places_the_cache(build_dirs, monkeypatch,
                                           tmp_path):
    monkeypatch.setenv("DISTGCN_TORCH_CACHE", str(tmp_path))
    cfg = Config.from_args(["--num_layer=3"])
    assert cfg.num_layer == 3
    assert _build.BUILD_DIR == tmp_path / "kernels"
    assert exact.BUILD_DIR == tmp_path / "native"
