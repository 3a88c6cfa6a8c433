"""BENCHMARK.json against the benchmark's contract, every name resolved
to its file, and a cell added as new files only."""

from __future__ import annotations

import json
import re

import pytest

from bench_h100 import harness, readers
from bench_h100.tests import tiny
from bench_h100.trace import Trace

REPO = tiny.REPO
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench_h100"]
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (REPO / SPEC["command"][1]).is_file()
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lengths():
    names = [c["name"] for c in SPEC["configs"]] + CELLS \
        + [m["name"] for m in METRICS]
    for name in names:
        assert NAME.match(name), name
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.find_cell(REPO, cell)
    assert c.config["name"] == c.config_name
    harness.load_module(REPO, "drivers", c.traffic["driver"])
    e2e = {m["name"] for m in harness.metrics_for(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metrics_for(SPEC, cell, True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_resolves(metric):
    assert callable(harness.load_module(REPO, "metrics", metric).read)


def test_every_config_is_used_and_states_its_cut():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"].startswith("bench_h100/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert (REPO / cfg["checkpoint"]).is_file()


def test_layers_name_one_layer_each():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"])
    perf = (REPO / "PERF.md").read_text()
    for layer in by_layer:
        assert layer in perf, f"PERF.md does not list the layer {layer!r}"


def _trace():
    # two kernels of 1 us and 3 us, a copy of 1 us; 10 us of host window
    device = [("lgs_kernel(char*)", 0, 1000, True),
              ("fused_layer_kernel(x)", 2000, 5000, True),
              ("Memcpy HtoD", 4000, 6000, False)]
    host = [("aten::item", 900, 2100), ("cudaLaunchKernel", 1500, 1600)]
    return Trace(device=device, host=host, window_s=10e-6, units=2,
                 counters={"nbr_max_launches": 12})


def test_readers_on_a_hand_made_trace():
    from types import SimpleNamespace
    run = SimpleNamespace(trace=_trace(), cell=None, work={
        "slots_per_unit": 3, "gcn_flops": 67e12 * 0.5, "timed_s": 1.0,
        "timed_units": 200_000,
        "kernels": {"lgs": {"match": "lgs_kernel", "bound_s": 0.25e-6}}})
    # busy: [0, 1] and [2, 6] us -> 2.5 us a unit, of 5 us a unit untraced
    assert readers.idle_pct(run) == pytest.approx(50.0)
    assert readers.kernels_per_slot(run) == pytest.approx(2 / 6)
    assert readers.mfu_pct(run) == pytest.approx(50.0)
    assert readers.roofline_pct(run, "lgs") == pytest.approx(25.0)
    assert readers.roofline_pct(run, "nbr_max") is None
    assert readers.counter_per_slot(run, "nbr_max_launches", 2.0) == 1.0
    bd = run.trace.breakdown()
    assert bd["device_ops"][0][0] == "fused_layer_kernel(x)"
    assert bd["idle_gaps"] == [["cudaLaunchKernel", pytest.approx(1e-6)]]


def test_a_cell_added_as_new_files_runs(tmp_path):
    """A throwaway cell, its configuration, traffic and limits written into
    a fresh root beside copies of the drivers and readers: no file that is
    there is edited, and the cell runs end to end on the CPU."""
    root = tiny.make_root(tmp_path, {"tiny_dense_gdpg":
                                     ("tiny_dense", "tiny_gdpg")})
    out = harness.run_cell(root, "tiny_dense_gdpg", 4_294_967_311, 0.05,
                           False, device="cpu")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"decisions_per_s", "setup_s"}
    assert list(out)[-1] == "check"


def test_trace_reads_kernels_and_skips_annotations():
    from types import SimpleNamespace
    import torch
    from bench_h100 import trace

    def ev(name, dev, start, dur, kind):
        return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                               start_ns=lambda: start,
                               duration_ns=lambda: dur,
                               activity_type=lambda: kind)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    evs = [ev("ProfilerStep#1", cuda, 0, 100, "gpu_user_annotation"),
           ev("ProfilerStep#1", cpu, 0, 100, "user_annotation"),
           ev("lgs_kernel", cuda, 10, 5, "kernel"),
           ev("Memcpy HtoD", cuda, 20, 5, "gpu_memcpy"),
           ev("aten::mul", cpu, 5, 10, "cpu_op")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    device, host, steps = trace._read(prof)
    assert device == [("lgs_kernel", 10, 15, True),
                      ("Memcpy HtoD", 20, 25, False)]
    assert host == [("aten::mul", 5, 15)]
    assert steps == [(0, 100)]


def test_calibrate_is_a_command():
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "bench_h100/calibrate.py", "--help"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "--fault" in out.stdout, out.stderr
