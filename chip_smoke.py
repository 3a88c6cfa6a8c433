"""Drive the PyTorch/CUDA port (`distgcn_tpu_torch`) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. card details, then the build of every kernel in
   `distgcn_tpu_torch/csrc/` with nvcc (build time, registers, shared
   memory);
2. the LGS kernel against its plain PyTorch version at B=128, N=256 on
   seeded random graphs (density ~20/n): random weights, engineered ties,
   negative weights, max_rounds=1, and a ragged N=100. Selections must be
   bit-equal and the kernel's largest per-graph round count must equal the
   plain round count;
3. the solve pipeline with the repo's ERGDPG2 20-layer c32 checkpoint
   (gcn2_dqn) on that batch in f32: every schedule independent and
   maximal, GCN scores equal to the CPU path's on 8 graphs, and the mean
   utility ratio against the greedy baseline;
4. the main path: the closed loop at B=128, N=256, load 0.9 with the same
   model, f32 and bf16, feature modes gdpg (GCN hoisted) and dqn (GCN every
   slot). Queues finite, >= 0 and exactly 0 on padding; the LGS kernel
   launched at least once per slot; bf16 `avg_utility` within 1% of f32.
   Per-slot ms and graphs/s come from the marginal between T=100 and T=500
   episodes (host clock after `torch.cuda.synchronize()`);
5. kernel timings at B=128, N=256 with CUDA events around CUDA-graph
   replays (L2 flushed between launches), beside the plain version's and
   the memory bound.

The line before the last is the card's name and power limit as nvidia-smi
reports them; the one before it a JSON object with one entry per kernel.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.agents import build_state_arrays
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.ops.lgs import batched_lgs_plain, lgs_ranks
from distgcn_tpu_torch.ops.lgs_cuda import batched_lgs_kernel, launch
from distgcn_tpu_torch.pipeline import make_solve_pipeline
from distgcn_tpu_torch.sim.device_sim import make_closed_loop
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.serialization import load_params

B, N = 128, 256
N_MIN = 100                    # smallest graph of a batch
CKPT = ("model/result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn/"
        "params.npz")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, outside the tensor cores
L2_FLUSH_BYTES = 64 << 20      # > the 50 MB L2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def graphs(rng, b, n_lo, n_hi, weights="random"):
    """Seeded random conflict graphs with density ~20/n (bench.py's)."""
    adjs, wtss = [], []
    for _ in range(b):
        n = int(rng.integers(n_lo, n_hi + 1))
        a = np.triu(rng.random((n, n)) < min(1.0, 20.0 / n), 1)
        adjs.append(sp.csr_matrix((a | a.T).astype(np.float32)))
        w = rng.random(n)
        wtss.append({"random": w, "ties": np.ones(n),
                     "negative": w - 0.5}[weights])
    return adjs, wtss


def independent_and_maximal(sel, adj, mask) -> bool:
    on = sel == 1
    a = adj > 0
    independent = not bool((a & on[:, :, None] & on[:, None, :]).any())
    covered = on | (a & on[:, None, :]).any(dim=-1)
    return independent and bool(covered[mask].all())


def event_ms(fn, iters, flush=None) -> float:
    """Mean device time of fn() over `iters` launches, CUDA events around
    each launch; `flush` (a large buffer) is rewritten between launches so
    every launch finds a cold L2."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        if flush is not None:
            flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def phase_build(smi: str) -> None:
    print(f"phase 1: {smi} (name, power limit); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} "
          f"device(s)", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.3f} s",
          flush=True)
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"phase 1: {name}.cu ptxas: {line.strip()}")
    words = (N + 31) // 32
    smem = (N * (words | 1) + N + 2 * words) * 4
    print(f"phase 1: lgs dynamic shared memory at N={N}: {smem} bytes per "
          f"CTA, {words * 32} threads")


def phase_kernel_vs_plain(dev) -> float:
    rng = np.random.default_rng(0)
    cases = [("random", N, None), ("ties", N, None), ("negative", N, None),
             ("random", N, 1), ("random", 100, None)]
    worst = 0.0
    for weights, n, cap in cases:
        adjs, wtss = graphs(rng, B, min(N_MIN, n) // 2, n, weights)
        gb = GraphBatch.from_scipy(adjs, wtss, pad_to=n, device=dev)
        sel, util, rounds = batched_lgs_kernel(gb.adj, gb.wts, gb.mask, cap)
        torch.cuda.synchronize()
        psel, putil, prounds = batched_lgs_plain(gb.adj, gb.wts, gb.mask,
                                                 cap)
        torch.cuda.synchronize()
        err = float((sel.float() - psel.float()).abs().max())
        worst = max(worst, err)
        check(torch.equal(sel, psel), f"sel differs ({weights}, N={n}, "
              f"max_rounds={cap})")
        check(int(rounds.max()) == int(prounds),
              f"rounds {int(rounds.max())} != {int(prounds)}")
        uerr = float((util - putil).abs().max())
        print(f"phase 2: {weights:8s} N={n:3d} max_rounds={cap}: sel "
              f"bit-equal, rounds {int(prounds)} (per graph "
              f"{int(rounds.min())}..{int(rounds.max())}), util max abs "
              f"diff {uerr:.3g}", flush=True)
    return worst


def phase_pipeline(dev, cfg, tree) -> None:
    rng = np.random.default_rng(1)
    adjs, wtss = graphs(rng, B, N_MIN, N)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    model = make_model_from_config(cfg, "gcn2_dqn",
                                   params=params_from_jax(tree), device=dev)
    solve = make_solve_pipeline(model, cfg, "gdpg", with_baseline=True)
    before = batched_lgs_kernel.launches
    sel, util, gutil = solve(gb.adj, gb.wts, gb.mask)
    torch.cuda.synchronize()
    check(batched_lgs_kernel.launches - before == 2,
          "solve pipeline did not launch the LGS kernel twice")
    check(tuple(sel.shape) == (B, N) and bool(torch.isfinite(util).all()),
          "pipeline outputs")
    check(independent_and_maximal(sel, gb.adj, gb.mask),
          "a pipeline schedule is not independent and maximal")
    # reference: the same forward on the CPU, first 8 graphs
    cpu_model = make_model_from_config(cfg, "gcn2_dqn",
                                       params=params_from_jax(tree),
                                       device="cpu")
    with torch.no_grad():
        feats, sups = build_state_arrays(gb.adj[:8], gb.wts[:8],
                                         gb.mask[:8], cfg.feature_size,
                                         cfg.max_degree)
        got = model(feats, sups).cpu()
        want = cpu_model(feats.cpu(), sups.cpu())
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=1e-5, rtol=1e-4),
          f"GCN scores differ from the CPU path by {err}")
    ratio = float((util / gutil).mean())
    print(f"phase 3: ERGDPG2 l20 c32 solve pipeline f32, B={B} N={N}: "
          f"schedules independent+maximal, GCN vs CPU max abs diff "
          f"{err:.3g}, mean utility ratio vs greedy {ratio:.6f}",
          flush=True)


def phase_closed_loop(dev, cfg, tree) -> None:
    rng = np.random.default_rng(2)
    adjs, wtss = graphs(rng, B, N_MIN, N)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    model = make_model_from_config(cfg, "gcn2_dqn",
                                   params=params_from_jax(tree), device=dev)
    q0 = torch.zeros((B, N), device=dev)
    avg_util = {}
    for mode in ("gdpg", "dqn"):
        for dt in ("float32", "bfloat16"):
            cfg_d = cfg.replace(compute_dtype=dt)
            runs = {t: make_closed_loop(model, cfg_d, timeslots=t, load=0.9,
                                        feature_mode=mode)
                    for t in (3, 100, 500)}
            runs[3](gb.adj, gb.mask, q0,
                    torch.Generator(device=dev).manual_seed(0))  # warm-up
            secs = {}
            for t in (100, 500):
                gen = torch.Generator(device=dev).manual_seed(7)
                torch.cuda.synchronize()
                before = batched_lgs_kernel.launches
                t0 = time.perf_counter()
                qT, metrics = runs[t](gb.adj, gb.mask, q0, gen)
                torch.cuda.synchronize()
                secs[t] = time.perf_counter() - t0
                check(batched_lgs_kernel.launches - before >= t,
                      f"{mode}/{dt}: fewer than {t} kernel launches")
                check(bool(torch.isfinite(qT).all())
                      and bool((qT >= 0).all()), f"{mode}/{dt}: queues")
                check(bool((qT[~gb.mask] == 0).all()),
                      f"{mode}/{dt}: padding queues not 0")
            avg_util[mode, dt] = float(metrics["avg_utility"].mean())
            slot_s = (secs[500] - secs[100]) / 400
            print(f"phase 4: closed loop {mode:4s} {dt:8s}: T=100 "
                  f"{secs[100]:.4f} s, T=500 {secs[500]:.4f} s, per slot "
                  f"{slot_s * 1e3:.4f} ms, {B / slot_s:.1f} graphs/s, "
                  f"avg_queue_len {float(metrics['avg_queue_len'].mean()):.4f}"
                  f", avg_utility {avg_util[mode, dt]:.2f}", flush=True)
        f32, bf16 = avg_util[mode, "float32"], avg_util[mode, "bfloat16"]
        rel = abs(bf16 - f32) / abs(f32)
        check(rel <= 0.01, f"{mode}: bf16 avg_utility off by {rel:.4%}")
        print(f"phase 4: {mode} bf16 vs f32 avg_utility rel diff {rel:.4%}")
    print(f"phase 4: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB",
          flush=True)


def graph_ms(fn, iters, flush=None) -> float:
    """Mean device time of fn() captured once in a CUDA graph and replayed
    between CUDA events: the host's enqueue time of fn's launches is not
    counted."""
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


def phase_timing(dev) -> dict:
    rng = np.random.default_rng(3)
    adjs, wtss = graphs(rng, B, N_MIN, N)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    ranks = lgs_ranks(gb.wts)
    rounds = batched_lgs_kernel(gb.adj, gb.wts, gb.mask)[2]
    torch.cuda.reset_peak_memory_stats(dev)

    def wrapper():
        return batched_lgs_kernel(gb.adj, gb.wts, gb.mask)

    ms = graph_ms(wrapper, 200, flush)
    kernel_ms = graph_ms(lambda: launch(gb.adj, ranks, gb.mask, N), 200,
                         flush)
    ranks_ms = graph_ms(lambda: lgs_ranks(gb.wts), 200, flush)
    eager_ms = event_ms(wrapper, 200, flush)
    peak = torch.cuda.max_memory_allocated(dev)
    plain_ms = event_ms(lambda: batched_lgs_plain(gb.adj, gb.wts, gb.mask),
                        20, flush)
    # least work: read adj, wts, mask once; write sel, util, rounds once
    nbytes = B * N * N + B * N * (4 + 1 + 1) + B * (4 + 4)
    # least operations: each round, a node compares at most every
    # neighbour's rank once (one per directed edge), on this run's rounds
    ops = int((gb.adj > 0).sum(dim=(1, 2)).to(torch.int64).mul(
        rounds.to(torch.int64)).sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"phase 5: lgs B={B} N={N}, L2 flushed before each launch: "
          f"batched_lgs_kernel {ms:.4f} ms (graph replay; "
          f"{eager_ms:.4f} ms enqueued eagerly), of which the CUDA kernel "
          f"{kernel_ms:.4f} ms and lgs_ranks {ranks_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us ({nbytes} "
          f"bytes; operations {ops_ms * 1e3:.4f} us); at {bound_ms / ms:.2%}"
          f" of the bound (kernel alone {bound_ms / kernel_ms:.2%}); "
          f"rounds per graph {int(rounds.min())}..{int(rounds.max())}; "
          f"peak memory {peak / 2**20:.1f} MiB", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase_build(smi)
    cfg = Config(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                 max_degree=1, predict="mwis", pad_to=N, batch_size=B)
    tree = load_params(CKPT)
    max_err = phase_kernel_vs_plain(dev)
    phase_pipeline(dev, cfg, tree)
    batched_lgs_kernel.launches = 0
    phase_closed_loop(dev, cfg, tree)
    launches = batched_lgs_kernel.launches
    check(launches > 0, "the closed loop never launched the LGS kernel")
    timing = phase_timing(dev)
    kernel = {"name": "lgs", "route": "cuda",
              "source": "distgcn_tpu_torch/csrc/lgs.cu",
              "replaces": "distgcn_tpu/ops/lgs_pallas.py:48",
              "launches": launches, "max_abs_err": max_err, **timing,
              "library_ms": None}
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
