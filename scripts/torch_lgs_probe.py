#!/usr/bin/env python3
"""Where the LGS kernel's time goes on a CUDA card.

Runs `batched_lgs_kernel` (weights in; selection, utility and rounds out)
on seeded random graphs of density ~20/n with ragged masks at (B, N) =
(128, 256) (the dense main path's shape, graphs of 100..256 nodes), (32,
1024), (4, 1100), (4, 2048) and (4, 4096), and prints its time: CUDA
events around CUDA-graph replays, the mean of `--iters` replays with the
L2 flushed before each (as `chip_smoke.py` phase 5 times it); and one
launch's share of a graph of 20 (flush, launch) pairs less the 20 flushes
alone, which leaves out the host's enqueue between a flush and a replay.

Then, unless `--no-clocks`, it builds `distgcn_tpu_torch/csrc/lgs.cu` with
``-DLGS_CLOCKS=1`` through `ops/_build.py` and prints, per shape, the SM
cycles thread 0 of a CTA spends in each phase, averaged over the CTAs
(`ops.lgs_cuda.PHASES`: issuing the first loads, weights to keys, ranks,
position map, waiting for the first bytes, packing the rows, states,
rounds, outputs), the largest CTA's cycles and the time from the first
CTA's start to the last CTA's end on the global timer
(`ops.lgs_cuda.read_clocks`). The clock build's selections must equal the
plain build's.

With `--no-clocks` only `batched_lgs_kernel(adj, wts, mask)` is called, so
the script times an earlier tree of the package too: put that tree first
on PYTHONPATH.

Usage, from the repository root on a machine with a card:
    python3 scripts/torch_lgs_probe.py [--no-clocks] [--iters 100]
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

# appended, so that a tree on PYTHONPATH comes first
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distgcn_tpu_torch.ops import lgs_cuda  # noqa: E402

SHAPES = ((128, 256), (32, 1024), (4, 1100), (4, 2048), (4, 4096))
L2_FLUSH_BYTES = 64 << 20      # > the 50 MB L2


def batch(b, n, dev, seed=0):
    """int8 adj [b, n, n], f32 weights and bool mask: graph i has n_i
    nodes (100..256 at n = 256, n/2..n otherwise), density ~20/n_i."""
    rng = np.random.default_rng(seed)
    lo = 100 if n == 256 else n // 2
    sizes = rng.integers(lo, n + 1, b)
    a = np.zeros((b, n, n), bool)
    for i, k in enumerate(sizes):
        t = np.triu(rng.random((k, k)) < min(1.0, 20.0 / k), 1)
        a[i, :k, :k] = t | t.T
    m = np.arange(n)[None, :] < sizes[:, None]
    w = rng.random((b, n)) * m
    return (torch.from_numpy(a.astype(np.int8)).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev),
            torch.from_numpy(m).to(dev))


def graph_ms(fn, iters, flush) -> float:
    """Mean device time of fn() captured in a CUDA graph, replayed between
    CUDA events with `flush` (if any) rewritten before each replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        if flush is not None:
            flush.zero_()
        starts[i].record()
        graph.replay()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def in_graph_ms(fn, flush, k=20, iters=20) -> float:
    """Device time of one fn() inside a graph of k (flush, fn) pairs, less
    a graph of the k flushes alone: no host enqueue between the two."""
    def pairs():
        for _ in range(k):
            flush.zero_()
            fn()

    def flushes():
        for _ in range(k):
            flush.zero_()

    return (graph_ms(pairs, iters, None) - graph_ms(flushes, iters, None)) / k


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-clocks", action="store_true")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; package {os.path.dirname(lgs_cuda.__file__)}",
          flush=True)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    clocks = not args.no_clocks
    for b, n in SHAPES:
        adj, wts, mask = batch(b, n, dev)

        def run():
            return lgs_cuda.batched_lgs_kernel(adj, wts, mask)

        ms = graph_ms(run, args.iters, flush)
        line = (f"B={b} N={n}: {ms:.4f} ms; in a graph of 20 after their "
                f"flushes {in_graph_ms(run, flush):.4f} ms a launch")
        if clocks:
            want = run()[0]
            cd = lgs_cuda.CLOCK_DEFINES
            lgs_cuda.launch(adj, wts, mask, n, defines=cd)  # built, warm
            lgs_cuda.read_clocks()
            csel = lgs_cuda.launch(adj, wts, mask, n, defines=cd)[0]
            sums = lgs_cuda.read_clocks()
            if not torch.equal(csel, want):
                print("the clock build's selections differ", file=sys.stderr)
                return 1
            ctas = max(1, sums.pop("ctas"))
            max_cta, span_ns = sums.pop("max_cta"), sums.pop("span_ns")
            total = sum(sums.values())
            line += (f"; clock build: first CTA start to last CTA end "
                     f"{span_ns / 1e3:.2f} us, largest CTA {max_cta} cycles")
            line += f"; cycles per CTA {total / ctas:.0f}: " + ", ".join(
                f"{k} {v / ctas:.0f} ({v / max(1, total):.1%})"
                for k, v in sums.items())
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
