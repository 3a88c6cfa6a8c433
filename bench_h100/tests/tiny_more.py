"""Tiny versions of the diver cell and of the large gdpg episode cell for
the CPU tests: a checkout root made by `tiny.make_root`, given these
cells as new files only (configurations, traffic and limits beside the
benchmark's own drivers and readers)."""

from __future__ import annotations

import json
from pathlib import Path

from bench_h100.tests import tiny

BENCH, REPO = tiny.BENCH, tiny.REPO
DIVER_CKPT = str(REPO / "model"
                 / "result_ERUNI_deep_ld32_c32_l20_cheb1_diver32_mwis_diver"
                 / "params.npz")

CELLS = {"tiny_diver": ("tiny_eruni", "tiny_bsf"),
         "tiny_large_gdpg": ("tiny_geo", "tiny_gdpg_episodes")}
KIND = {"tiny_diver": "diver_bsf_er512_g64",
        "tiny_large_gdpg": "large_gdpg_geo65k"}


def config(name: str, **sizes) -> dict:
    if name == "tiny_geo":
        cfg = tiny.config("tiny_geo")
        cfg["graph"].update(sizes)
        return cfg
    cfg = json.loads((BENCH / "configs"
                      / "eruni_diver32_l20c32_er512.json").read_text())
    cfg.update(name=name, checkpoint=DIVER_CKPT)
    cfg["graphs"].update(dict(dict(batch=6, n_lo=12, n_hi=30, pad_to=32,
                                   mean_degree=4.0), **sizes))
    return cfg


def traffic(name: str, **keys) -> dict:
    if name == "tiny_bsf":
        t = json.loads((BENCH / "traffic" / "bsf_p8_g64.json").read_text())
        t.update(group=3, check_groups=2, trace_groups=1)
    else:
        t = json.loads((BENCH / "traffic"
                        / "large_gdpg_t50_load09.json").read_text())
        t.update(timeslots=12, check_episodes=2, check_among=3,
                 trace_episodes=1)
    t.update(keys)
    return t


def make_root(tmp: Path, cells=CELLS, sizes=None, keys=None) -> Path:
    """`tmp` as a checkout root holding `cells`, each metric's workloads
    those of its real cell; `sizes` and `keys` update a configuration's
    graph sizes and a traffic mix's keys, by cell."""
    sizes, keys = sizes or {}, keys or {}
    root = tiny.make_root(tmp, {})
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    real = {m["name"]: m for m in json.loads(
        (REPO / "BENCHMARK.json").read_text())["end_to_end"]
        + json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c in cells
                              if KIND[c] in real[m["name"]]["workloads"]]
    for cell, (cfg, tr) in cells.items():
        file = f"bench_h100/configs/{cfg}.json"
        tiny._dump(root / file, config(cfg, **sizes.get(cell, {})))
        spec["configs"].append({"name": cfg, "source": "tiny", "file": file,
                                "reduced": [], "why": "tiny"})
        tiny._dump(root / "bench_h100" / "traffic" / f"{tr}.json",
                   traffic(tr, **keys.get(cell, {})))
        tiny._dump(root / "bench_h100" / "limits" / f"{cell}.json",
                   json.loads((BENCH / "limits"
                               / f"{KIND[cell]}.json").read_text()))
        spec["workloads"].append({"name": cell, "config": cfg,
                                  "traffic": tr, "chips": 1, "why": "tiny"})
    tiny._dump(path, spec)
    return root
