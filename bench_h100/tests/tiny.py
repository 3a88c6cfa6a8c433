"""A checkout root of tiny cells for the CPU tests: the benchmark's own
drivers, readers and generators, with configurations and traffic small
enough for the CPU, written as new files only (as a later change would
add a cell)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
CKPT = str(REPO / "model" / "result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn"
           / "params.npz")

CELLS = {
    "tiny_dense_dqn": ("tiny_dense", "tiny_dqn"),
    "tiny_dense_gdpg": ("tiny_dense", "tiny_gdpg"),
    "tiny_large": ("tiny_geo", "tiny_slot"),
    "tiny_large_weighted": ("tiny_geo_weighted", "tiny_slot"),
}


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def config(name: str) -> dict:
    real = json.loads((BENCH / "configs" / {
        "tiny_dense": "ergdpg2_l20c32_dense_b512.json",
        "tiny_geo": "ergdpg2_l20c32_geo65k.json",
        "tiny_geo_weighted": "ergdpg2_l20c32_geo65k_weighted.json"}[name]
    ).read_text())
    real["name"] = name
    real["checkpoint"] = CKPT
    if name == "tiny_dense":
        real["graphs"] = {"generator": "er_batch", "batch": 6, "n_lo": 12,
                          "n_hi": 30, "pad_to": 32, "mean_degree": 4.0}
    else:
        real["graph"].update(n=1024, avg_degree=12.0)
    return real


def traffic(name: str) -> dict:
    real = {"tiny_dqn": "dqn_t500_load09", "tiny_gdpg": "gdpg_t500_load09",
            "tiny_slot": "slot_dqn_load09"}[name]
    t = json.loads((BENCH / "traffic" / f"{real}.json").read_text())
    t.update(timeslots=12, warmup_slots=2, trace_episodes=1, trace_slots=3,
             check_slots=4, check_episodes=2)
    return t


def make_root(tmp: Path, cells=CELLS) -> Path:
    """`tmp` as a checkout root holding the tiny cells."""
    shutil.copytree(BENCH / "drivers", tmp / "bench_h100" / "drivers")
    shutil.copytree(BENCH / "metrics", tmp / "bench_h100" / "metrics")
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    spec = {k: real[k] for k in ("command", "paths", "run_seconds",
                                 "end_to_end", "per_layer")}
    kind = {"tiny_dense_dqn": "dense_dqn_b512",
            "tiny_dense_gdpg": "dense_dqn_b512",     # the same metrics, limits
            "tiny_large": "large_dqn_geo65k",
            "tiny_large_weighted": "large_dqn_geo65k_weighted"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c in cells if kind[c] in m["workloads"]]
    spec["configs"], spec["workloads"] = [], []
    for cfg in sorted({c for c, _ in cells.values()}):
        file = f"bench_h100/configs/{cfg}.json"
        _dump(tmp / file, config(cfg))
        spec["configs"].append({"name": cfg, "source": "tiny", "file": file,
                                "reduced": [], "why": "tiny"})
    for cell, (cfg, tr) in cells.items():
        _dump(tmp / "bench_h100" / "traffic" / f"{tr}.json", traffic(tr))
        _dump(tmp / "bench_h100" / "limits" / f"{cell}.json", json.loads(
            (BENCH / "limits" / f"{kind[cell]}.json").read_text()))
        spec["workloads"].append({"name": cell, "config": cfg,
                                  "traffic": tr, "chips": 1, "why": "tiny"})
    _dump(tmp / "BENCHMARK.json", spec)
    return tmp
