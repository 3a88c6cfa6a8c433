#!/usr/bin/env python3
"""Where the port's trainer time goes on a CUDA card.

With the repo's ERGDPG2 20-layer c32 checkpoint (gcn2_dqn, f32, TF1 Adam
lr 1e-4) on seeded graphs of 100..256 nodes padded to N=256, prints for
  - the replay (`rl.train.ReplayTrainer.step`, one TF1 Adam update per
    sample): host wall per sample of the forward + loss alone, of forward
    + `torch.autograd.grad`, and of the whole step (so the backward's and
    the update's shares), then under torch.profiler the device's busy time
    per sample, its share of the wall and the kernels launched per sample;
  - the online training slot (`make_online_training_loop`, B=128) and the
    train pipeline batch (`make_train_pipeline`, B=128): the same wall,
    busy and kernel counts per slot / per batch;
  - the kernels that take the most device time in each.

Usage, from the repository root on a machine with a card:
    python3 scripts/torch_trainer_profile.py [--samples 50] [--slots 20]
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

from distgcn_tpu_torch.agents import DQNAgent, build_state_arrays  # noqa
from distgcn_tpu_torch.core.graph import GraphBatch  # noqa: E402
from distgcn_tpu_torch.models.gcn import params_from_jax  # noqa: E402
from distgcn_tpu_torch.pipeline import make_train_pipeline  # noqa: E402
from distgcn_tpu_torch.rl.train import make_optimizer, replay_loss  # noqa
from distgcn_tpu_torch.sim.device_sim import \
    make_online_training_loop  # noqa: E402
from distgcn_tpu_torch.utils.config import Config  # noqa: E402
from distgcn_tpu_torch.utils.serialization import load_params  # noqa

B, N, LR = 128, 256, 1e-4
CKPT = os.path.join(ROOT, "model", "result_ERGDPG2_deep_ld1_c32_l20_cheb1_"
                    "diver1_mwis_dqn", "params.npz")


def graphs(rng, b):
    adjs, wtss = [], []
    for _ in range(b):
        n = int(rng.integers(100, N + 1))
        a = np.triu(rng.random((n, n)) < 20.0 / n, 1)
        adjs.append(sp.csr_matrix((a | a.T).astype(np.float32)))
        wtss.append(rng.random(n))
    return adjs, wtss


def wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(fn, units: int, label: str, unit: str) -> None:
    """Wall, device busy time and kernel launches per unit under
    torch.profiler, and the top kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        secs = wall(fn)
    per_kernel = defaultdict(float)
    count = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] += evt.time_range.elapsed_us()
            count += 1
    busy = sum(per_kernel.values())
    print(f"{label}: under the profiler {secs / units * 1e3:.4f} ms/{unit} "
          f"wall, device busy {busy / units / 1e3:.4f} ms/{unit} = "
          f"{busy / (secs * 1e6):.1%} of wall, {count / units:.1f} kernels/"
          f"{unit}", flush=True)
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / units:9.2f} us/{unit}  {name[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--slots", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    cfg = Config(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                 max_degree=1, predict="mwis", pad_to=N, learning_rate=LR)
    tree = load_params(CKPT)
    agent = DQNAgent(cfg, device=dev)
    agent.model.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(3)

    # the replay: memorize K samples through the train pipeline
    k = args.samples
    adjs, wtss = graphs(rng, k)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    rand = torch.rand((k, N), device=dev)
    explore = torch.zeros(k, dtype=torch.bool, device=dev)
    sel, util, gutil, acts = make_train_pipeline(agent.model, cfg)(
        gb.adj, gb.wts, gb.mask, rand, explore)
    sel, acts = sel.cpu().numpy(), acts.cpu().numpy()
    reward = (util / gutil).cpu().numpy()
    minibatch = [({"adj": a, "wts": w.astype(np.float32)},
                  acts[i, :a.shape[0]], np.nonzero(sel[i] == 1)[0].tolist(),
                  {}, float(reward[i])) for i, (a, w) in
                 enumerate(zip(adjs, wtss))]
    trainer = agent.trainer
    adj, wts, mask, labels = trainer.prepare(minibatch)
    feats, sups = build_state_arrays(adj, wts, mask > 0, 1, 1)
    params = list(agent.model.parameters())

    def forward():
        for i in range(k):
            replay_loss(agent.model, feats[i], sups[i], labels[i], mask[i],
                        cfg.weight_decay)

    def forward_backward():
        for i in range(k):
            torch.autograd.grad(replay_loss(
                agent.model, feats[i], sups[i], labels[i], mask[i],
                cfg.weight_decay), params)

    def step():
        trainer.step(adj, wts, mask, labels)

    step()                                              # warm-up
    f, fb, s = wall(forward), wall(forward_backward), wall(step)
    print(f"replay, {k} samples: forward + loss {f / k * 1e3:.4f} ms/sample,"
          f" + autograd.grad {fb / k * 1e3:.4f}, whole step (+ TF1 update) "
          f"{s / k * 1e3:.4f}: backward {(fb - f) / k * 1e3:.4f}, update "
          f"{(s - fb) / k * 1e3:.4f} ms/sample", flush=True)
    profiled(step, k, "replay", "sample")

    # the online training slot and the train pipeline batch, B=128
    adjs, wtss = graphs(rng, B)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    opt = make_optimizer(LR)
    state = [opt.init(dict(agent.model.named_parameters()))]
    run = make_online_training_loop(agent.model, cfg, opt,
                                    timeslots=args.slots, load=0.9)
    q0 = torch.zeros((B, N), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def episode():
        state[0] = run(state[0], gb.adj, gb.mask, q0, gen)[0]

    episode()                                           # warm-up
    print(f"online slot, B={B}: {wall(episode) / args.slots * 1e3:.4f} "
          f"ms/slot wall", flush=True)
    profiled(episode, args.slots, "online", "slot")
    pipe = make_train_pipeline(agent.model, cfg)
    rand = torch.rand((B, N), device=dev)
    explore = torch.arange(B, device=dev) % 2 == 0

    def batches():
        for _ in range(10):
            pipe(gb.adj, gb.wts, gb.mask, rand, explore)

    batches()                                           # warm-up
    print(f"train pipeline, B={B}: {wall(batches) / 10 * 1e3:.4f} ms/batch "
          f"wall", flush=True)
    profiled(batches, 10, "train pipeline", "batch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
