"""Runs one cell of `BENCHMARK.json` once and prints its result.

Everything is found by name under a checkout root: the cell in
`BENCHMARK.json`, its configuration at the entry's ``file``, its traffic
at ``bench_h100/traffic/<traffic>.json``, the traffic's driver at
``bench_h100/drivers/<driver>.py``, the limits of its correctness numbers
at ``bench_h100/limits/<cell>.json`` and each per-layer metric's reader at
``bench_h100/metrics/<metric>.py``. Adding a cell, a configuration, a
traffic mix, a driver or a metric is adding files and entries.

A driver module has ``run(cell, seed, seconds, trace, device) -> dict``
with the keys ``e2e`` (end-to-end values by name), ``attempted``,
``failed``, ``checks`` (a list of (name, value, limit)),
``memory_peak_bytes``, and with a trace ``trace`` (a `trace.Trace`) and
``work`` (what the readers need: model FLOPs of the timed part, kernel
bounds). A reader module has ``read(run) -> float | None``, `run` holding
``trace``, ``work`` and ``cell``; None leaves the metric out.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, Optional

BENCH_DIR = "bench_h100"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "distgcn_tpu"})


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    root: Path

    def path(self, rel: str) -> Path:
        return self.root / rel


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    c = configs[w["config"]]
    return Cell(name=name, config_name=c["name"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=load_json(root / c["file"]),
                traffic=load_json(root / BENCH_DIR / "traffic"
                                  / f"{w['traffic']}.json"),
                limits=load_json(root / BENCH_DIR / "limits"
                                 / f"{name}.json"),
                root=root)


def load_module(root: Path, kind: str, name: str) -> ModuleType:
    """``bench_h100/<kind>/<name>.py`` under `root` as a module."""
    path = root / BENCH_DIR / kind / f"{name}.py"
    mod_name = f"_bench_{kind}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on), as BENCHMARK.json assigns them."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def verdict(checks) -> bool:
    """`correct`: every compared number within its limit."""
    return all(value <= limit for _, value, limit in checks)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> Dict:
    """Runs the cell once; returns the result line's object (with its
    ``check`` key last) and the lines for standard error."""
    spec = load_json(root / "BENCHMARK.json")
    cell = find_cell(root, name)
    driver = load_module(root, "drivers", cell.traffic["driver"])
    res = driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                     device=device)
    wanted = metrics_for(spec, name, trace)
    metrics = {}
    if trace:
        view = SimpleNamespace(trace=res["trace"], work=res["work"],
                               cell=cell)
        for m in wanted:
            value = load_module(root, "metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in wanted:
            metrics[m["name"]] = {"value": float(res["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    checks = res["checks"]
    correct = verdict(checks)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": res.get("kind", device), "count": cell.chips,
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if res.get("power_limit"):
        dev["power_limit"] = res["power_limit"]
    out = {"correct": correct, "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    for key in ("setup_phases", "compile_s", "unit_s", "host"):
        if res.get(key):
            out[key] = res[key]
    if trace:
        tr = res["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["check"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out
