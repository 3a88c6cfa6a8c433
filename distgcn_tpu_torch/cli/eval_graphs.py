"""Graph-set evaluation driver — port of `distgcn_tpu/cli/eval_graphs.py`
(the reference's `mwis_dqn_test.py`).

Loads a trained model by the reference naming convention, sweeps a test
dataset, reports the per-instance ratio to the centralized greedy baseline
and writes ``{output_dir}/{model_name}_{dataset}.csv`` with columns
["data", "p"] (mwis_dqn_test.py:302-348). Instances are evaluated in padded
device batches (`pipeline.BatchedEvaluator`).

Rollout mode (``--rollout=1``): the centralized tree-search sweep — a
GCN_DEEP_DIVER model drives the best-solution-first queue
(`DiverAgent.solve_mwis_bsf_many`, `--group` instances in lockstep) per
instance, with the reference's resumable-CSV protocol: rows with p == 0 are
tried again on the next run (mwis_dqn_test.py:302-318), files added since
get new rows and rows for vanished files are dropped.

The CSV is written and read with the `csv` module in pandas' ``to_csv``
layout (an unnamed index column, then ``data`` and ``p``), so a sweep that
one package began resumes under the other. `--device` picks the card
(default ``cuda``; ``cpu`` runs the plain PyTorch paths).

Usage:
    python -m distgcn_tpu_torch.cli.eval_graphs --datapath=data/ER_..._test2 \\
        --training_set=IS4SAT --num_layer=1 --hidden1=32 --feature_size=1 \\
        --diver_num=1 --max_degree=1 --predict=mwis [--model_root=...] \\
        [--rollout=1 --max_pops=8]
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np

from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.pipeline import BatchedEvaluator
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.directory import find_model_folder


def _extra_args(argv):
    extra = argparse.ArgumentParser()
    extra.add_argument("--model_root", default="./model")
    extra.add_argument("--output_dir", default="./output")
    extra.add_argument("--rollout", type=int, default=0)
    extra.add_argument("--max_pops", type=int, default=8)
    extra.add_argument("--batch_pops", type=int, default=8,
                       help="bsf states evaluated per device call")
    extra.add_argument("--group", type=int, default=4,
                       help="instances searched in lockstep, sharing "
                            "device calls (solve_mwis_bsf_many)")
    extra.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")
    return extra.parse_known_args(argv)[0]


def write_csv(path: str, rows) -> None:
    """rows: [(data, p)] -> pandas' ``to_csv`` layout (index 0..k-1)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "data", "p"])
        for i, (name, p) in enumerate(rows):
            w.writerow([i, name, repr(float(p))])


def read_csv(path: str):
    """The rows [(data, p)] of a CSV in pandas' ``to_csv`` layout, in
    index order."""
    with open(path, newline="") as f:
        r = csv.reader(f)
        header = next(r)
        col = {name: j for j, name in enumerate(header)}
        rows = [(int(line[0]), line[col["data"]], float(line[col["p"]]))
                for line in r if line]
    return [(name, p) for _, name, p in sorted(rows)]


def main(argv=None):
    cfg = Config.from_args(argv)
    ns = _extra_args(argv)
    if ns.rollout:
        return rollout_main(cfg, ns)

    model_origin = find_model_folder(cfg, "dqn", ns.model_root)
    agent = DQNAgent(cfg, model_family="gcn_dqn", device=ns.device)
    if not agent.load(model_origin):
        print(f"Unable to load {model_origin}")

    from distgcn_tpu_torch.data.matio import load_dataset_cached
    insts = load_dataset_cached(cfg.datapath)

    ev = BatchedEvaluator(agent, batch_size=cfg.batch_size,
                          device=agent.device)
    t0 = time.time()
    utils, gutils = ev.evaluate([(i.adj, i.weights) for i in insts])
    runtime = time.time() - t0

    ratios = utils / np.maximum(gutils, 1e-9)
    os.makedirs(ns.output_dir, exist_ok=True)
    # the reference writes ./output/{model}.csv (mwis_dqn_test.py:348); the
    # dataset name keeps sweeps over several test sets apart
    ds = os.path.basename(os.path.normpath(cfg.datapath))
    out_csv = os.path.join(ns.output_dir,
                           model_origin.split("/")[-1] + f"_{ds}.csv")
    write_csv(out_csv, [(inst.name, ratios[i])
                        for i, inst in enumerate(insts)])
    print(f"instances: {len(insts)}  mean ratio vs greedy: "
          f"{np.mean(ratios):.6f}  runtime: {runtime:.2f}s "
          f"({len(insts)/runtime:.1f} graphs/s)  -> {out_csv}")
    return float(np.mean(ratios))


def rollout_main(cfg: Config, ns):
    """DGCN-RS tree-search sweep: one best-solution-first search per
    instance (device-batched diver-head evaluations per pop), resumable
    CSV."""
    from distgcn_tpu_torch.agents_extra import DiverAgent
    from distgcn_tpu_torch.data.matio import list_dataset, load_mat
    from distgcn_tpu_torch.solvers.greedy import greedy_search

    model_origin = find_model_folder(cfg, "diver", ns.model_root)
    agent = DiverAgent(cfg, device=ns.device)
    if not agent.load(model_origin):
        print(f"Unable to load {model_origin}")

    files = list_dataset(cfg.datapath)
    ds = os.path.basename(os.path.normpath(cfg.datapath))
    os.makedirs(ns.output_dir, exist_ok=True)
    out_csv = os.path.join(
        ns.output_dir,
        model_origin.split("/")[-1] + f"_rs{ns.max_pops}_{ds}.csv")
    if os.path.isfile(out_csv):
        rows = read_csv(out_csv)
        # reconcile with the dataset listing: files added since the CSV
        # was written get p=0 rows; rows whose files vanished are dropped
        known = {name for name, _ in rows}
        rows += [(f, 0.0) for f in files if f not in known]
        present = set(files)
        rows = [(name, p) for name, p in rows if name in present]
    else:
        rows = [(f, 0.0) for f in files]

    t0 = time.time()
    todo = [i for i, (_, p) in enumerate(rows) if p == 0]
    done_cnt = 0
    for start in range(0, len(todo), ns.group):
        chunk = todo[start: start + ns.group]
        insts = [load_mat(os.path.join(cfg.datapath, rows[i][0]))
                 for i in chunk]
        results = agent.solve_mwis_bsf_many(
            [(inst.adj, inst.weights) for inst in insts],
            max_pops=ns.max_pops, batch_pops=ns.batch_pops, group=ns.group)
        for idx, inst, (_, util) in zip(chunk, insts, results):
            _, gutil = greedy_search(inst.adj, inst.weights)
            rows[idx] = (rows[idx][0], util / gutil if gutil else 1.0)
        done_cnt += len(chunk)
        if done_cnt % 24 < ns.group or done_cnt == len(todo):
            write_csv(out_csv, rows)
            done = [p for _, p in rows if p > 0]
            print(f"{done_cnt}/{len(todo)}  mean p so far: "
                  f"{np.mean(done):.6f}  "
                  f"({done_cnt / (time.time() - t0):.2f} graphs/s)",
                  flush=True)
    write_csv(out_csv, rows)
    solved = [p for _, p in rows if p > 0]
    mean = float(np.mean(solved)) if solved else float("nan")
    print(f"rollout sweep: {len(solved)}/{len(rows)} instances, mean ratio "
          f"vs greedy {mean:.6f} -> {out_csv}")
    return mean


if __name__ == "__main__":
    main()
