#!/usr/bin/env python3
"""The sharded giant-graph solve across D processes, one card each.

For each world size D in ``--worlds`` this script starts D worker
processes of itself, joined by `parallel.distributed.initialize` from the
DISTGCN_* environment (NCCL on cards, gloo with ``--device cpu``). Every
worker builds the same graph (`geometric_conflict_graph(n, avg_degree=48,
seed=0, order="grid")`, the large path's bench graph at n=65,536), shards
it with `shard_large_graph(adj, D, block_size=256)` and runs
`make_sharded_large_solve` on its slab: the dqn solve with a seeded
``--layers``-deep, ``--width``-wide K=1 ChebGCN, and the bias-only model
with predict="mwis" (scores = raw weights). Rank 0 writes the gathered
selections, utilities and timings to ``--out``.

Each worker also times, with CUDA events (host clock on the CPU), one ring
step's parts: `ring_shift` of an [n/D, width] f32 shard (the SpMM's
travelling shard) and of an [n/D] int32 shard (the LGS ranks), one
`psum` of a flag read on the host (once per LGS round), one SpMM panel
product, and one whole ring SpMM (`anorm` of a layer). The solve's time is
the marginal of 2 and 6 solves (host clock after a synchronise and a
barrier), the largest over the ranks. Rank 0 also writes
`torch.profiler` tables of two bias-only solves and one dqn solve
(``world<D>_profile.txt``).

The launcher then holds every D against the first: the bias-only
selections must be equal and its utility within rtol 1e-5; the dqn
solve's utility within rtol 1e-5, its schedule independent and maximal,
and how many selections differ is printed (the ring sums a row's blocks
panel by panel, so its f32 rounding differs from D=1's). It prints one
JSON line and exits 1 if a check failed.

Usage, from the repository root (one card per rank, so D=4 needs four):
    python3 scripts/torch_sharded_nccl.py --worlds 1,2,4
    python3 scripts/torch_sharded_nccl.py --device cpu --n 4096 \\
        --layers 3 --width 16        # gloo, a small graph
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import marginal_ms, sync  # noqa: E402
from distgcn_tpu_torch.large import (geometric_conflict_graph,  # noqa: E402
                                     params_to_list)
from distgcn_tpu_torch.models.gcn import ChebGCN  # noqa: E402
from distgcn_tpu_torch.ops.spmm import spmm_rows  # noqa: E402
from distgcn_tpu_torch.parallel import distributed  # noqa: E402
from distgcn_tpu_torch.parallel.halo import (psum, ring_reduce,  # noqa: E402
                                             ring_shift)
from distgcn_tpu_torch.parallel.large_sharded import (  # noqa: E402
    make_sharded_large_solve, shard_arrays, shard_large_graph)

BLOCK = 256
ITERS = 20                     # timed calls of each ring step's part
WORKER_TIMEOUT_S = 600


def parse():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--worlds", default="1,2,4")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--layers", type=int, default=20)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--out", default="chiprun_out/sharded_nccl")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args()


# ---------------------------------------------------------------------------
# worker: one rank
# ---------------------------------------------------------------------------

def model_params(layers, width, dev):
    """A seeded K=1 ChebGCN (gcn_dqn: no bias, linear head), per layer."""
    model = ChebGCN(in_dim=1, num_layer=layers, hidden_dim=width, out_dim=1,
                    num_supports=2, generator=torch.Generator().manual_seed(0))
    tree = {}
    for name, value in model.state_dict().items():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = value
    return params_to_list(tree, device=dev)


def op_ms(fn, iters, dev) -> float:
    """Mean time of fn() over `iters` calls after one warm-up: CUDA events
    on a card, the host clock on the CPU; every rank enters together."""
    fn()
    sync(dev)
    dist.barrier()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def solve_ms(fn, dev, k_lo=2, k_hi=6) -> float:
    """Per-solve ms, the marginal of k_lo and k_hi solves after one
    warm-up, the largest over the ranks."""
    fn()
    return marginal_ms(lambda k: [fn() for _ in range(k)], k_lo, k_hi,
                       dev)[0]


def profile(args, dev, rank, world, bias_only, dqn) -> None:
    """torch.profiler tables of two bias-only solves and one dqn solve,
    sorted by host and by device time; rank 0 writes them."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    tables = []
    for name, fn, reps in (("bias-only", bias_only, 2), ("dqn", dqn, 1)):
        sync(dev)
        dist.barrier()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            sync(dev)
        ka = prof.key_averages()
        for key in ("self_cpu_time_total", "self_device_time_total"):
            if key == "self_device_time_total" and dev.type != "cuda":
                continue
            tables.append(f"== {name} x{reps}, D={world}, rank {rank}, by "
                          f"{key}\n" + ka.table(sort_by=key, row_limit=25))
    if rank == 0:
        (Path(args.out) / f"world{world}_profile.txt").write_text(
            "\n\n".join(tables))


def worker(args) -> None:
    dev = torch.device(args.device)
    if not distributed.initialize(device=dev):
        raise RuntimeError("run as a worker with the DISTGCN_* environment")
    try:
        rank, world, _, _ = distributed.process_info()
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dev.type == "cuda" else dev
        t0 = time.perf_counter()
        adj, wts, _ = geometric_conflict_graph(args.n, avg_degree=48.0,
                                               seed=0, order="grid")
        sg = shard_large_graph(adj, world, block_size=BLOCK)
        a = shard_arrays(sg, device=dev)
        w = np.zeros(sg.n_pad, np.float32)
        w[:sg.n] = wts
        w_loc = distributed.host_to_local(w, rank, world, dev)
        plist = model_params(args.layers, args.width, dev)
        bplist = params_to_list({"gc1": {"w_0": torch.zeros(1, 1),
                                         "w_1": torch.zeros(1, 1),
                                         "bias": torch.ones(1)}}, device=dev)
        solve = make_sharded_large_solve(sg, predict="dqn", device=dev)
        bsolve = make_sharded_large_solve(sg, predict="mwis", device=dev)
        sync(dev)
        setup_s = time.perf_counter() - t0

        sel, util = solve(*a[:4], plist, w_loc, a[4])
        bsel, butil = bsolve(*a[:4], bplist, w_loc, a[4])
        sel_all = distributed.gather_global(sel)[:sg.n].cpu().numpy()
        bsel_all = distributed.gather_global(bsel)[:sg.n].cpu().numpy()

        # one ring step's parts, and one whole ring SpMM
        n_loc = sg.n_loc
        gen = torch.Generator(device=dev).manual_seed(rank)
        y = torch.randn((n_loc, args.width), generator=gen, device=dev)
        ranks = torch.arange(n_loc, dtype=torch.int32, device=dev)
        flag = torch.ones((), dtype=torch.int32, device=dev)
        ind, rptr, cols = a[0], a[1], a[2]

        def panel(src, shard):
            return spmm_rows(ind[src], rptr[src], cols[src], shard, n_loc,
                             BLOCK, sg.bitmap)

        it = ITERS
        parts = {
            "ring_shift_f32_ms": op_ms(lambda: ring_shift(y), it, dev),
            "ring_shift_i32_ms": op_ms(lambda: ring_shift(ranks), it, dev),
            "psum_host_read_ms": op_ms(lambda: int(psum(flag)), it, dev),
            "spmm_panel_ms": op_ms(lambda: panel(rank, y), it, dev),
            "ring_spmm_ms": op_ms(
                lambda: ring_reduce(y, panel, torch.add), it, dev),
            "solve_dqn_ms": solve_ms(
                lambda: solve(*a[:4], plist, w_loc, a[4]), dev),
            "solve_bias_only_ms": solve_ms(
                lambda: bsolve(*a[:4], bplist, w_loc, a[4]), dev),
        }
        profile(args, dev, rank, world,
                lambda: bsolve(*a[:4], bplist, w_loc, a[4]),
                lambda: solve(*a[:4], plist, w_loc, a[4]))
        if rank == 0:
            out = Path(args.out)
            np.savez(out / f"world{world}.npz", sel=sel_all, bsel=bsel_all)
            (out / f"world{world}.json").write_text(json.dumps({
                "world": world, "device": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "n": sg.n, "n_loc": n_loc, "nnz_blocks": sg.nnz_blocks,
                "nb_max": sg.nb_max, "setup_s": setup_s,
                "util": float(util), "bias_only_util": float(butil),
                **parts}))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(args, world: int) -> None:
    base = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                DISTGCN_COORDINATOR=f"localhost:{free_port()}",
                DISTGCN_NUM_PROCESSES=str(world))
    if args.device == "cpu":
        base["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, __file__, "--worker", "--device", args.device,
           "--n", str(args.n), "--layers", str(args.layers), "--width",
           str(args.width), "--out", args.out]
    procs = [subprocess.Popen(cmd, env=dict(base, DISTGCN_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} failed:\n{log}")


def schedule_ok(sel, adj) -> bool:
    picked = np.flatnonzero(sel == 1)
    covered = np.zeros(sel.size, bool)
    covered[picked] = True
    covered[np.unique(adj[picked].indices)] = True
    return bool(adj[picked][:, picked].nnz == 0 and covered.all())


def main() -> int:
    args = parse()
    if args.worker:
        worker(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    worlds = [int(x) for x in args.worlds.split(",")]
    if args.device == "cuda" and max(worlds) > torch.cuda.device_count():
        print(f"D={max(worlds)} needs {max(worlds)} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    Path(args.out).mkdir(parents=True, exist_ok=True)
    adj, _, _ = geometric_conflict_graph(args.n, avg_degree=48.0, seed=0,
                                         order="grid")
    results, ok = [], True
    for world in worlds:
        t0 = time.perf_counter()
        run_world(args, world)
        res = json.loads((Path(args.out) / f"world{world}.json").read_text())
        arrs = np.load(Path(args.out) / f"world{world}.npz")
        res["wall_s"] = time.perf_counter() - t0
        res["schedule_ok"] = schedule_ok(arrs["sel"], adj)
        if results:
            ref = np.load(Path(args.out) / f"world{worlds[0]}.npz")
            ref_res = results[0]
            res["dqn_sel_differ"] = int((arrs["sel"] != ref["sel"]).sum())
            res["bias_only_sel_differ"] = int(
                (arrs["bsel"] != ref["bsel"]).sum())
            res["dqn_util_rel"] = abs(res["util"] - ref_res["util"]) / abs(
                ref_res["util"])
            res["bias_only_util_rel"] = abs(
                res["bias_only_util"] - ref_res["bias_only_util"]) / abs(
                ref_res["bias_only_util"])
            ok &= (res["bias_only_sel_differ"] == 0
                   and res["bias_only_util_rel"] <= 1e-5
                   and res["dqn_util_rel"] <= 1e-5)
        ok &= res["schedule_ok"]
        print(json.dumps(res), flush=True)
        results.append(res)
    smi = "not run"
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().replace("\n", "; ")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": bool(ok), "worlds": worlds}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
