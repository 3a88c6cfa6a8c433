"""Optimal/benchmark solver CLI — port of
`distgcn_tpu/cli/benchmark_solver.py` (the reference's `mwis_mlp_test.py`).

Sweeps a dataset with the exact MWIS solver (the port's native B&B, in
place of Gurobi), the HiGHS MILP, the proving portfolio, or the clique-LP
message-passing rounding (`mp_greedy`), writing per-instance ``p`` =
solver_util / greedy_util, runtime and status to a resumable CSV. Host
code only: no device is used.

Resume semantics parity (mwis_mlp_test.py:79-152): rows with p == 0 are
re-attempted on each sweep with the timeout escalated x10, until none remain
or `max_sweeps` is hit. ``--shard i/k`` processes the rows with
index % k == i into a ``_shard{i}`` CSV; ``--merge_shards k`` folds them
into the main CSV.

The CSVs are written and read with the `csv` module in pandas' ``to_csv``
layout (an unnamed index column, then data, p, runtime, status), so a
sweep that one package began resumes under the other.

Usage:
    python -m distgcn_tpu_torch.cli.benchmark_solver \\
        --datapath=data/..._test2 --solver=optimal --timeout=10
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import time
from typing import List

from distgcn_tpu_torch.data.matio import list_dataset, load_mat
from distgcn_tpu_torch.solvers import exact
from distgcn_tpu_torch.solvers.greedy import greedy_search
from distgcn_tpu_torch.utils.config import Config

COLS = ("data", "p", "runtime", "status")


def read_table(path: str) -> List[dict]:
    """The rows of a sweep CSV in index order (a missing status reads as
    the empty string)."""
    with open(path, newline="") as f:
        r = csv.reader(f)
        col = {name: j for j, name in enumerate(next(r))}
        rows = sorted((int(line[0]), line) for line in r if line)
    return [{"data": line[col["data"]], "p": float(line[col["p"]]),
             "runtime": float(line[col["runtime"]]),
             "status": line[col["status"]]} for _, line in rows]


def write_table(path: str, rows: List[dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", *COLS])
        for i, row in enumerate(rows):
            w.writerow([i, row["data"], repr(float(row["p"])),
                        repr(float(row["runtime"])), row["status"]])


def _cost(fname: str) -> float:
    """Edge-count proxy: cheap rows first within a sweep."""
    m = re.search(r"_n(\d+)_p([\d.]+)_", fname)
    return float(m.group(1)) ** 2 * float(m.group(2)) if m else 0.0


def _solve(solver: str, inst, timeout: float):
    """(utility, status) of one instance under `solver`."""
    if solver == "optimal":
        _, util, status = exact.mwis_exact(inst.adj, inst.weights, timeout)
    elif solver == "milp":
        _, util, status = exact.mwis_milp(inst.adj, inst.weights, timeout)
    elif solver == "auto":
        # the proving portfolio (`exact.mwis_prove`)
        _, util, status = exact.mwis_prove(inst.adj, inst.weights, timeout,
                                           verbose=True)
    else:
        from distgcn_tpu_torch.solvers.relax import mp_greedy
        _, util = mp_greedy(inst.adj, inst.weights)
        status = "Rounded"
    return util, status


def main(argv=None, max_sweeps: int = 3):
    cfg = Config.from_args(argv)
    extra = argparse.ArgumentParser()
    extra.add_argument("--output_dir", default="./output")
    extra.add_argument("--shard", default="",
                       help="'i/k': process only rows with index%%k==i, "
                            "writing to a _shard{i} CSV (merge with "
                            "--merge_shards k when all workers finish)")
    extra.add_argument("--merge_shards", type=int, default=0,
                       help="fold _shard{0..k-1} CSVs into the main CSV")
    ns, _ = extra.parse_known_args(argv)

    files = list_dataset(cfg.datapath)
    dataset = os.path.basename(os.path.normpath(cfg.datapath))
    solver_tag = {"optimal": "mwis_exact", "auto": "mwis_exact",
                  "milp": "mwis_milp"}.get(cfg.solver, "mp_clique_greedy")
    os.makedirs(ns.output_dir, exist_ok=True)
    main_csv = os.path.join(ns.output_dir, f"{solver_tag}_{dataset}.csv")

    if ns.merge_shards:
        rows = read_table(main_csv)
        for i in range(ns.merge_shards):
            scsv = main_csv.replace(".csv", f"_shard{i}.csv")
            if not os.path.isfile(scsv):
                continue
            for idx, srow in enumerate(read_table(scsv)):
                if srow["p"] > 0 and rows[idx]["p"] == 0:
                    rows[idx].update(p=srow["p"], runtime=srow["runtime"],
                                     status=srow["status"])
        write_table(main_csv, rows)
        print(f"merged: {sum(r['p'] > 0 for r in rows)}/{len(rows)} proven "
              f"-> {main_csv}")
        return rows

    shard_i, shard_k = 0, 1
    if ns.shard:
        shard_i, shard_k = (int(t) for t in ns.shard.split("/"))
    out_csv = main_csv if shard_k == 1 else \
        main_csv.replace(".csv", f"_shard{shard_i}.csv")

    if os.path.isfile(out_csv):
        rows = read_table(out_csv)
    elif shard_k > 1 and os.path.isfile(main_csv):
        rows = read_table(main_csv)  # seed shard from main
    else:
        rows = [{"data": f, "p": 0.0, "runtime": 0.0, "status": ""}
                for f in files]

    timeout = float(cfg.timeout)
    for sweep in range(max_sweeps):
        todo = [i for i, row in enumerate(rows)
                if row["p"] == 0 and i % shard_k == shard_i]
        todo.sort(key=lambda i: _cost(rows[i]["data"]))
        if not todo:
            break
        print(f"sweep {sweep}: {len(todo)} unsolved, timeout {timeout}s")
        for idx in todo:
            fname = rows[idx]["data"]
            inst = load_mat(os.path.join(cfg.datapath, fname))
            _, greedy_util = greedy_search(inst.adj, inst.weights)
            t0 = time.time()
            util, status = _solve(cfg.solver, inst, timeout)
            runtime = time.time() - t0
            ratio = util / greedy_util if greedy_util else 1.0
            # only proven (or heuristic) rows count as done; Timeout and
            # Failed(x) rows stay p=0 for the next sweep
            rows[idx].update(
                p=ratio if status in ("Optimal", "Rounded") else 0.0,
                runtime=runtime, status=status)
            write_table(out_csv, rows)
            print(f"{fname}: p={ratio:.6f} status={status} "
                  f"runtime={runtime:.2f}s")
        # escalate (mwis_mlp_test.py:152), capped at the reference tail's
        # own budget (Gurobi needed up to ~3000 s there)
        timeout = min(timeout * 10, 3600.0)
    solved = [row["p"] for row in rows if row["p"] > 0]
    if solved:
        print(f"mean p over {len(solved)} solved: "
              f"{sum(solved) / len(solved):.6f} -> {out_csv}")
    return rows


if __name__ == "__main__":
    main()
