#!/usr/bin/env python3
"""The multi-card dry run, the data-parallel train step and the
data-sharded closed loop on D cards.

For each world size D in ``--worlds`` this script starts D worker
processes of itself, joined by `parallel.distributed.initialize` from the
DISTGCN_* environment (NCCL on cards, gloo with ``--device cpu``). Every
group runs the paths named by ``--paths`` on each (n_data, n_model) layout
of its world: (1, 1) at D=1, (2, 1) at D=2, (4, 1) and (2, 2) at D=4.

- ``dryrun``: `dryrun.dryrun_multichip(D)` (at D=4 the 2x2 grid); its
  selections must be independent and maximal.
- ``step``: `parallel.mesh.make_sharded_train_step` at the full width of
  `chip_smoke.py` phase 21 (the ERGDPG2 l20 c32 checkpoint, B=128 graphs
  of 100..256 nodes padded to 256, seeded labels). One step from the
  checkpoint gives the loss and the parameters; the time per step is the
  marginal of 2 and 6 steps (host clock after a synchronise and a
  barrier), the largest over the ranks, and the step's all-reduce is timed
  alone (CUDA events around 20 calls; the helpers are
  `scripts/torch_sharded_nccl.py`'s).
- ``loop``: `sim.device_sim.make_closed_loop(..., mesh=)` at the width of
  `chip_smoke.py` phases 4 and 22 (the same checkpoint, N=256, load 0.9,
  gdpg f32 with the greedy baseline, phase 4's graphs and generator seed),
  with strong scaling (128 graphs in all) and weak scaling (128 graphs
  per data index); D=1 also runs each weak batch of the other worlds on
  its one card. The ms a slot is the marginal between episodes of 100 and
  500 slots (host clock after a synchronise and a barrier, the largest
  over the ranks); graphs/s is B over it.

Rank 0 writes everything to ``--out``. The launcher holds every layout
against (1, 1): the step's loss within rtol 1e-5 and every parameter
within rtol 1e-5 plus atol 1e-6; the loop's queueT and metrics (of the
shorter episode) within rtol 1e-5 of D=1's on the same batch, and it
reports whether they are bit-equal and which graphs differ. It prints one
JSON line per world and a last JSON line, and exits 1 if a check failed.

Usage, from the repository root (one card per rank, so D=4 needs four):
    python3 scripts/torch_dryrun_multichip.py
    python3 scripts/torch_dryrun_multichip.py --paths loop
    python3 scripts/torch_dryrun_multichip.py --device cpu \\
        --paths dryrun,step                                   # gloo, ~1.5 min
The loop's CPU cases, at a small size, are in
`tests/test_torch_closed_loop_sharded.py`.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (CKPT, TRAIN_LR, free_port,  # noqa: E402
                        independent_and_maximal, loop_batch, loop_config,
                        loop_slot_ms, schedule_ok, step_batch, sync,
                        train_config)
from distgcn_tpu_torch import dryrun  # noqa: E402
from distgcn_tpu_torch.models.gcn import (  # noqa: E402
    make_model_from_config, params_from_jax)
from distgcn_tpu_torch.parallel import distributed  # noqa: E402
from distgcn_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, make_sharded_train_step)
from distgcn_tpu_torch.rl.train import make_optimizer  # noqa: E402
from distgcn_tpu_torch.sim.device_sim import make_closed_loop  # noqa: E402
from distgcn_tpu_torch.utils.serialization import load_params  # noqa: E402
from torch_sharded_nccl import op_ms, solve_ms  # noqa: E402

LAYOUTS = {1: ((1, 1),), 2: ((2, 1),), 4: ((4, 1), (2, 2))}
RTOL, ATOL = 1e-5, 1e-6
WORKER_TIMEOUT_S = 600
PATHS = ("dryrun", "step", "loop")
LOOP_B = 128                   # the loop's graphs in all / per data index
LOOP_SLOTS = (100, 500)        # the loop's two episode lengths


def parse():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--worlds", default="1,2,4")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default="chiprun_out/dryrun_multichip")
    p.add_argument("--paths", default=",".join(PATHS),
                   help="comma-separated subset of " + ",".join(PATHS))
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    args.paths = args.paths.split(",")
    if not set(args.paths) <= set(PATHS):
        p.error(f"--paths takes a subset of {','.join(PATHS)}")
    args.worlds = [int(x) for x in args.worlds.split(",")]
    return args


def loop_sizes(worlds, world: int, n_data: int) -> list:
    """The loop's batch sizes on an (n_data, .) layout: strong and weak
    scaling; D=1 also runs the weak batch of every other layout."""
    if world == 1:
        return sorted({LOOP_B * nd for w in worlds for nd, _ in LAYOUTS[w]})
    return sorted({LOOP_B, LOOP_B * n_data})


# ---------------------------------------------------------------------------
# worker: one rank
# ---------------------------------------------------------------------------

def worker(args) -> None:
    dev = torch.device(args.device)
    if not distributed.initialize(device=dev):
        raise RuntimeError("run as a worker with the DISTGCN_* environment")
    try:
        rank, world, _, _ = distributed.process_info()
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        res = {"world": world, "device": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu"}
        arrays = {}
        if "dryrun" in args.paths:
            res.update(run_dryrun(world, dev))
        if "step" in args.paths:
            res["layouts"] = run_step(world, dev, arrays)
        if "loop" in args.paths:
            res["loop"] = run_loop(args.worlds, world, dev, arrays)
        if rank == 0:
            out = Path(args.out)
            np.savez(out / f"world{world}.npz", **arrays)
            (out / f"world{world}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def run_dryrun(world: int, dev) -> dict:
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(world, device=dev)
    sync(dev)
    return {"dryrun_s": time.perf_counter() - t0,
            "dryrun": {k: dry[k] for k in ("mesh", "loss", "mean_util",
                                            "giant_graph_util")},
            "dryrun_valid": independent_and_maximal(
                dry["sel"], dry["adj"], dry["mask"]) and schedule_ok(
                dry["giant_sel"], dry["giant_adj"],
                dry["giant_sel"].numel())}


def run_step(world: int, dev, arrays: dict) -> dict:
    """The train step on each layout: loss, ms a step, the all-reduce's
    ms; the parameters into `arrays` under ``<n_data>x<n_model>/``."""
    cfg = train_config()
    tree = load_params(str(REPO / CKPT))
    batch = step_batch(dev)
    layouts = {}
    for n_data, n_model in LAYOUTS[world]:
        mesh = make_mesh(n_data, n_model)
        model = make_model_from_config(
            cfg, "gcn2_dqn", params=params_from_jax(tree), device=dev)
        opt = make_optimizer(TRAIN_LR)
        state = [opt.init(dict(model.named_parameters()))]
        step = make_sharded_train_step(model, cfg, opt, mesh)
        state[0], loss = step(state[0], *batch)
        tag = f"{n_data}x{n_model}"
        for k, v in model.state_dict().items():
            arrays[f"{tag}/{k}"] = v.cpu().numpy()

        def one():
            state[0], _ = step(state[0], *batch)

        # the step's one all-reduce alone: every gradient and the loss
        flat = torch.ones(1 + sum(p.numel() for p in model.parameters()),
                          device=dev)
        layouts[tag] = {
            "loss": float(loss), "ms_per_step": solve_ms(one, dev),
            "allreduce_ms": op_ms(lambda: dist.all_reduce(
                flat, group=mesh.data_group), 20, dev)
            if n_data > 1 else 0.0, "allreduce_floats": flat.numel()}
    return layouts


def run_loop(worlds, world: int, dev, arrays: dict) -> dict:
    """The sharded closed loop on each layout and batch size
    (`loop_sizes`): ms a slot and graphs/s under ``<n_data>x<n_model>`` /
    ``B<b>``; the shorter episode's queueT and metrics into `arrays` under
    ``loop/<n_data>x<n_model>/B<b>/``."""
    cfg = loop_config()
    model = make_model_from_config(
        cfg, "gcn2_dqn", params=params_from_jax(load_params(str(REPO / CKPT))),
        device=dev)
    sizes = {(nd, nm): loop_sizes(worlds, world, nd)
             for nd, nm in LAYOUTS[world]}
    gb = loop_batch(dev, max(max(v) for v in sizes.values()))
    out = {}
    for (n_data, n_model), bs in sizes.items():
        mesh = make_mesh(n_data, n_model)
        runs = {t: make_closed_loop(model, cfg, t, load=0.9,
                                    with_baseline=True, mesh=mesh)
                for t in LOOP_SLOTS}
        tag = f"{n_data}x{n_model}"
        out[tag] = {}
        for b in bs:
            adj, mask = gb.adj[:b], gb.mask[:b]
            q0 = torch.zeros(mask.shape, device=dev)
            runs[LOOP_SLOTS[0]](adj, mask, q0,
                                torch.Generator(device=dev).manual_seed(0))
            ms, eps = loop_slot_ms(runs, adj, mask, q0)
            queue, metrics = eps[LOOP_SLOTS[0]]
            arrays[f"loop/{tag}/B{b}/queue"] = queue.cpu().numpy()
            for k, v in metrics.items():
                arrays[f"loop/{tag}/B{b}/{k}"] = v.cpu().numpy()
            out[tag][f"B{b}"] = {"graphs_per_rank": b // n_data,
                                 "ms_per_slot": ms,
                                 "graphs_per_s": b / ms * 1e3}
    return out


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def run_world(args, world: int) -> None:
    base = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                DISTGCN_COORDINATOR=f"localhost:{free_port()}",
                DISTGCN_NUM_PROCESSES=str(world))
    if args.device == "cpu":
        base["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, __file__, "--worker", "--device", args.device,
           "--out", args.out, "--paths", ",".join(args.paths),
           "--worlds", ",".join(map(str, args.worlds))]
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


def excess(got, want) -> float:
    """The largest |got - want| beyond RTOL x |want| (<= ATOL passes)."""
    return float((np.abs(got - want) - RTOL * np.abs(want)).max())


def loop_vs_ref(arrs: dict, ref: dict, tag: str, b: int) -> dict:
    """One layout's loop results at batch b against D=1's: bit-equal, the
    largest excess beyond rtol 1e-5 (<= 0 passes), the graphs that
    differ."""
    pre = f"loop/{tag}/B{b}/"
    keys = [k[len(pre):] for k in arrs if k.startswith(pre)]
    differ = np.zeros(b, bool)
    worst = -np.inf
    for k in keys:
        got, want = arrs[pre + k], ref[f"loop/1x1/B{b}/{k}"]
        ne = got != want
        differ |= ne.reshape(b, -1).any(axis=1)
        worst = max(worst, excess(got, want))
    return {"bit_equal": not differ.any(), "rtol_excess": worst,
            "graphs_differ": np.flatnonzero(differ).tolist()}


def main() -> int:
    args = parse()
    if args.worker:
        worker(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    worlds = args.worlds
    if worlds[0] != 1:
        print("the first world must be 1: every layout is held against it",
              file=sys.stderr)
        return 1
    if args.device == "cuda" and max(worlds) > torch.cuda.device_count():
        print(f"D={max(worlds)} needs {max(worlds)} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ok, ref, ref_loss = True, None, None
    for world in worlds:
        t0 = time.perf_counter()
        run_world(args, world)
        res = json.loads((out / f"world{world}.json").read_text())
        arrs = dict(np.load(out / f"world{world}.npz"))
        res["wall_s"] = time.perf_counter() - t0
        ok &= res.get("dryrun_valid", True)
        if ref is None:
            ref = arrs
            ref_params = {k.split("/", 1)[1]: v for k, v in arrs.items()
                          if k.startswith("1x1/")}
            if "layouts" in res:
                ref_loss = res["layouts"]["1x1"]["loss"]
        for tag, lay in res.get("layouts", {}).items():
            lay["loss_rel"] = abs(lay["loss"] - ref_loss) / abs(ref_loss)
            lay["params_excess"] = max(excess(arrs[f"{tag}/{k}"], v)
                                       for k, v in ref_params.items())
            ok &= lay["loss_rel"] <= RTOL and lay["params_excess"] <= ATOL
        for tag, sizes in res.get("loop", {}).items():
            for key, lay in sizes.items():
                lay.update(loop_vs_ref(arrs, ref, tag, int(key[1:])))
                ok &= lay["rtol_excess"] <= 0
        print(json.dumps(res), flush=True)
    smi = "not run"
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().replace("\n", "; ")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": bool(ok), "worlds": worlds,
                      "paths": args.paths}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
