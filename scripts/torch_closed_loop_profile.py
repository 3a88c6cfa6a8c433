#!/usr/bin/env python3
"""Where the port's closed-loop slot time goes on a CUDA card.

Runs `distgcn_tpu_torch.sim.device_sim.make_closed_loop` at B=128, N=256,
load 0.9 with the repo's ERGDPG2 20-layer c32 checkpoint, in the modes
gdpg (GCN hoisted), dqn (GCN every slot) and nogcn (plain LGS), f32 and
bf16, and for each prints:
  - wall time per slot (host clock around an episode, after a synchronize);
  - the device's busy share (sum of kernel times over that wall time,
    from torch.profiler);
  - the kernels that take the most device time per slot.

Usage, from the repository root on a machine with a card:
    python3 scripts/torch_closed_loop_profile.py [--slots 50]
"""

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from distgcn_tpu_torch.core.graph import GraphBatch  # noqa: E402
from distgcn_tpu_torch.models.gcn import (make_model_from_config,  # noqa
                                          params_from_jax)
from distgcn_tpu_torch.sim.device_sim import make_closed_loop  # noqa: E402
from distgcn_tpu_torch.utils.config import Config  # noqa: E402
from distgcn_tpu_torch.utils.serialization import load_params  # noqa

B, N = 128, 256
CKPT = os.path.join(ROOT, "model", "result_ERGDPG2_deep_ld1_c32_l20_cheb1_"
                    "diver1_mwis_dqn", "params.npz")


def batch(dev):
    rng = np.random.default_rng(2)
    adjs, wtss = [], []
    for _ in range(B):
        n = int(rng.integers(100, N + 1))
        a = np.triu(rng.random((n, n)) < 20.0 / n, 1)
        adjs.append(sp.csr_matrix((a | a.T).astype(np.float32)))
        wtss.append(rng.random(n))
    return GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = Config(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                 max_degree=1, predict="mwis", pad_to=N, batch_size=B)
    model = make_model_from_config(
        cfg, "gcn2_dqn", params=params_from_jax(load_params(CKPT)),
        device=dev)
    gb = batch(dev)
    q0 = torch.zeros((B, N), device=dev)
    print(torch.cuda.get_device_name(0), flush=True)
    for mode, use_gcn in (("gdpg", True), ("dqn", True), ("nogcn", False)):
        for dt in ("float32", "bfloat16"):
            if not use_gcn and dt == "bfloat16":
                continue
            run = make_closed_loop(model, cfg.replace(compute_dtype=dt),
                                   timeslots=args.slots, load=0.9,
                                   feature_mode="dqn" if mode == "dqn"
                                   else "gdpg", use_gcn=use_gcn)
            gen = torch.Generator(device=dev).manual_seed(0)
            run(gb.adj, gb.mask, q0, gen)                      # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(gb.adj, gb.mask, q0, gen)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            per_kernel = defaultdict(float)
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    per_kernel[evt.name] += evt.time_range.elapsed_us()
            busy_us = sum(per_kernel.values())
            slot_ms = wall / args.slots * 1e3
            print(f"{mode:5s} {dt:8s}: {slot_ms:.4f} ms/slot wall (under "
                  f"the profiler), device busy "
                  f"{busy_us / args.slots / 1e3:.4f} ms/slot = "
                  f"{busy_us / (wall * 1e6):.1%} of wall", flush=True)
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
            for name, us in top:
                print(f"    {us / args.slots:9.2f} us/slot  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
