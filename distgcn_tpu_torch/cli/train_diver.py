"""Supervised GCN_DEEP_DIVER training driver — port of
`distgcn_tpu/cli/train_diver.py`.

Trains the diverse-head model (gcn/models.py:301-438) on labeled MWIS
datasets: the hindsight-min weighted CE against the `mwis_label` field
(Data_Generation.py:218-219), one TF1 Adam update per padded batch of
`--device_batch` graphs (`rl.train.make_supervised_diver_step`), with the
max-over-heads solution quality of `DiverAgent.solve_mwis_iterative` as the
checkpoint gate and the hindsight accuracy / F1 on labeled test graphs.
The port's `data.generate` labels with heuristics (``label_instance``), or
with the exact optimum of the port's native branch and bound
(``label_instance(exact=True)``). `--device` picks the card
(default ``cuda``; ``cpu`` runs the plain PyTorch paths).

Usage:
    python -m distgcn_tpu_torch.cli.train_diver \\
        --datapath=.../ER_Graph_Uniform_mixN_mixp_train0 \\
        --test_datapath=.../ER_Graph_Uniform_GEN21_test1 \\
        --num_layer=20 --hidden1=32 --diver_num=32 --feature_size=1 \\
        --learning_rate=1e-4 --epochs=3
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from distgcn_tpu_torch.agents import build_state_arrays
from distgcn_tpu_torch.agents_extra import DiverAgent
from distgcn_tpu_torch.core.graph import GraphBatch, pad_bucket
from distgcn_tpu_torch.data.matio import load_dataset_cached
from distgcn_tpu_torch.rl.losses import (hindsight_diver_accuracy,
                                         hindsight_diver_f1)
from distgcn_tpu_torch.rl.train import (make_optimizer,
                                        make_supervised_diver_step)
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.directory import find_model_folder


def main(argv=None, max_graphs_per_epoch=None):
    cfg = Config.from_args(argv)
    extra = argparse.ArgumentParser()
    extra.add_argument("--model_root", default="./model")
    extra.add_argument("--device_batch", type=int, default=64)
    extra.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")
    ns, _ = extra.parse_known_args(argv)

    agent = DiverAgent(cfg, device=ns.device)
    model_origin = find_model_folder(cfg, "diver", ns.model_root)
    agent.load(model_origin)
    dev = agent.device

    train = [i for i in load_dataset_cached(cfg.datapath)
             if i.mwis_label is not None]
    test = load_dataset_cached(cfg.test_datapath)
    if not train:
        raise SystemExit(f"no labeled instances in {cfg.datapath}")
    print(f"{len(train)} labeled train / {len(test)} test graphs",
          flush=True)

    optimizer = make_optimizer(cfg.learning_rate, cfg.learning_decay)
    opt_state = optimizer.init(dict(agent.model.named_parameters()))
    step = make_supervised_diver_step(agent.model, optimizer, cfg.diver_num)

    rng = np.random.default_rng(cfg.seed)
    best_ratio = 0.0
    bs = ns.device_batch
    for epoch in range(cfg.epochs):
        order = rng.permutation(len(train))
        if max_graphs_per_epoch:
            order = order[:max_graphs_per_epoch]
        losses = []
        t0 = time.time()
        for start in range(0, len(order), bs):
            batch = [train[i] for i in order[start: start + bs]]
            nmax = max(i.num_nodes for i in batch)
            pad = pad_bucket(nmax, cfg.pad_to)
            gb = GraphBatch.from_scipy([i.adj for i in batch],
                                       [i.weights for i in batch],
                                       pad_to=pad, device=dev)
            labels = np.zeros((len(batch), pad), np.float32)
            for j, inst in enumerate(batch):
                labels[j, : inst.num_nodes] = np.asarray(
                    inst.mwis_label, np.float32).flatten()
            features, supports = build_state_arrays(
                gb.adj, gb.wts, gb.mask, cfg.feature_size, cfg.max_degree,
                cfg.predict, agent.feature_mode)
            opt_state, loss = step(opt_state, features, supports, gb.mask,
                                   torch.from_numpy(labels).to(dev), gb.wts)
            losses.append(float(loss))

        # eval: max-over-heads search quality against the stored optimal
        # utility, plus the reference's hindsight max-over-heads accuracy
        # and F1 (gcn/models.py:344-361) on labeled test instances
        ratios, accs, f1s = [], [], []
        for inst in test[: min(len(test), 50)]:
            _, util = agent.solve_mwis_iterative(inst.adj, inst.weights)
            ref = inst.mwis_utility or inst.greedy_utility or 1.0
            ratios.append(util / ref)
            if inst.mwis_label is not None:
                state = agent.makestate(inst.adj, inst.weights)
                with torch.no_grad():
                    out = agent.model(state["features"], state["supports"])
                out = out * state["graph"].mask[..., None].to(out.dtype)
                logits = out[0, : inst.num_nodes, :].cpu()
                lab = torch.from_numpy(np.asarray(
                    inst.mwis_label, np.float32).flatten())
                accs.append(float(hindsight_diver_accuracy(
                    logits, lab, cfg.diver_num)))
                f1s.append(float(hindsight_diver_f1(
                    logits, lab, cfg.diver_num)[0]))
        ratio = float(np.mean(ratios))
        acc_s = f" Acc: {np.mean(accs):.4f} F1: {np.mean(f1s):.4f}" \
            if accs else ""
        print(f"Epoch: {epoch} Loss: {np.mean(losses):.6f} "
              f"Test/Opt_Ratio: {ratio:.6f}{acc_s} runtime: "
              f"{time.time() - t0:.1f}s", flush=True)
        if ratio > best_ratio:
            agent.save(model_origin)
            best_ratio = ratio
    return best_ratio


if __name__ == "__main__":
    main()
