#!/usr/bin/env python3
"""Time the weighted large-graph SpMM and solve of one checkout on a card.

The graph is `chip_smoke.py` phase 6's weighted copy: the bench graph
(`geometric_conflict_graph(65536, avg_degree=48, seed=0, order="grid")`)
with each undirected edge weighted uniformly in [0.5, 1.5) from seed 12,
built by `build_large_graph(block_size=512)`. The script times, with CUDA
events around CUDA-graph replays (L2 flushed before each), the SpMM of
the exact route (`large._make_spmm`, Anorm @ y at F=128) and
`ops.spmm.bsr_spmm_rows` on the 512-wide value matrix, and, on the host
clock after a synchronise, the weighted exact solve
(`make_large_solve(predict="dqn")`, a seeded 20-layer 128-wide K=1
ChebGCN) as the marginal of 2 and 6 solves. It uses only entry points
that every slice of the port has, so it times an older checkout as well:

    python3 scripts/torch_weighted_solve.py [--root DIR] [--label NAME]

``--root`` is the checkout whose `distgcn_tpu_torch` is imported (default:
this one); its kernels build into that checkout's `build/kernels/`. It
prints one JSON line with the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

L2_FLUSH_BYTES = 64 << 20


def event_ms(fn, iters, flush) -> float:
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def graph_ms(fn, iters, flush) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, iters, flush)


def marginal_s(fn, k_lo=2, k_hi=6, tries=2) -> float:
    fn(0)
    t = {}
    for k in (k_lo, k_hi):
        best = None
        for _ in range(tries):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(k):
                fn(i)
            torch.cuda.synchronize()
            el = time.perf_counter() - t0
            best = el if best is None else min(best, el)
        t[k] = best
    return (t[k_hi] - t[k_lo]) / (k_hi - k_lo)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_weighted_solve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from distgcn_tpu_torch import large
    from distgcn_tpu_torch.models.gcn import ChebGCN
    from distgcn_tpu_torch.ops.spmm import bsr_spmm_rows

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    adj, wts, _ = large.geometric_conflict_graph(65536, avg_degree=48.0,
                                                 seed=0, order="grid")
    wadj = sp.triu(adj, 1).tocsr()
    wadj.data = (np.random.default_rng(12).random(wadj.nnz)
                 + 0.5).astype(np.float32)
    t0 = time.perf_counter()
    g = large.build_large_graph((wadj + wadj.T).tocsr(), block_size=512,
                                device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = ChebGCN(in_dim=1, num_layer=20, hidden_dim=128, out_dim=1,
                    num_supports=2, generator=torch.Generator().manual_seed(0))
    tree = {}
    for name, value in model.state_dict().items():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = value
    plist = large.params_to_list(tree, device=dev)
    w = torch.zeros(g.n_pad)
    w[: g.n] = torch.from_numpy(wts)
    w = w.to(dev)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    y = torch.randn((g.n_pad, 128),
                    generator=torch.Generator(device=dev).manual_seed(13),
                    device=dev)
    anorm = large._make_spmm(g)
    route_ms = graph_ms(lambda: anorm(y), 50, flush)
    values_ms = graph_ms(lambda: bsr_spmm_rows(g.bsr, y, g.row_ptr), 50,
                         flush)
    solve = large.make_large_solve(g, predict="dqn")
    sel, util, _ = solve(plist, w)
    per_solve = marginal_s(lambda i: solve(plist, w * (1.0 + 0.001 * i)))
    print(json.dumps({
        "label": args.label or args.root, "card": smi,
        "route_spmm_ms": route_ms, "value_matrix_spmm_ms": values_ms,
        "solve_ms": per_solve * 1e3, "utility": float(util),
        "selected": int((sel == 1).sum()), "build_s": build_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
