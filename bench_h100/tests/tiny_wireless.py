"""Tiny versions of the two wireless cells for the CPU tests: a checkout
root made by `tiny.make_root`, given the cells as new files only (the
configuration cut to the first few repository networks, the traffic to a
few slots), beside the benchmark's own drivers and readers."""

from __future__ import annotations

import json
from pathlib import Path

from bench_h100.tests import tiny

BENCH, REPO = tiny.BENCH, tiny.REPO

CELLS = {"tiny_wireless_nch1": ("tiny_paper", "tiny_nch1"),
         "tiny_wireless_seq3": ("tiny_paper", "tiny_seq3")}
KIND = {"tiny_wireless_nch1": "wireless_nch1_paper20",
        "tiny_wireless_seq3": "wireless_seq3_paper20"}
TRAFFIC = {"tiny_nch1": "wireless_nch1_t200_l03_l09",
           "tiny_seq3": "wireless_seq3_t200_l06_l12"}


def config(count: int = 3) -> dict:
    cfg = json.loads((BENCH / "configs"
                      / "ergdpg2_l20c32_paper20.json").read_text())
    cfg.update(name="tiny_paper", checkpoint=tiny.CKPT)
    cfg["networks"].update(path=str(REPO / "data" / "wireless_test"),
                           count=count)
    return cfg


def traffic(name: str, **keys) -> dict:
    t = json.loads((BENCH / "traffic" / f"{TRAFFIC[name]}.json").read_text())
    t.update(timeslots=10, warmup_slots=2, check_episodes=2, check_among=2,
             trace_units=1)
    t.update(keys)
    return t


def make_root(tmp: Path, cells=CELLS, keys=None) -> Path:
    """`tmp` as a checkout root holding `cells`, each metric's workloads
    those of its real cell; `keys` update a traffic mix's keys, by cell."""
    keys = keys or {}
    root = tiny.make_root(tmp, {})
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    real = {m["name"]: m for m in real["end_to_end"] + real["per_layer"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c in cells
                              if KIND[c] in real[m["name"]]["workloads"]]
    file = "bench_h100/configs/tiny_paper.json"
    tiny._dump(root / file, config())
    spec["configs"].append({"name": "tiny_paper", "source": "tiny",
                            "file": file, "reduced": [], "why": "tiny"})
    for cell, (cfg, tr) in cells.items():
        tiny._dump(root / "bench_h100" / "traffic" / f"{tr}.json",
                   traffic(tr, **keys.get(cell, {})))
        tiny._dump(root / "bench_h100" / "limits" / f"{cell}.json",
                   json.loads((BENCH / "limits"
                               / f"{KIND[cell]}.json").read_text()))
        spec["workloads"].append({"name": cell, "config": cfg,
                                  "traffic": tr, "chips": 1, "why": "tiny"})
    tiny._dump(path, spec)
    return root
