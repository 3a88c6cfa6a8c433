"""DQN training driver — port of `distgcn_tpu/cli/train_dqn.py` (the
reference's `mwis_dqn_origin.py`).

The epoch shape of GDPG training with the legacy DQN agent family
(`agents_extra.LegacyDQNAgent`: GCN_DQN model, value-randomizing epsilon,
assignment targets, retained memory) and replay(500)
(mwis_dqn_origin.py:455). Checkpoints are gated on the mean test ratio
improving (:451-453), the gate seeded from a loaded checkpoint's own test
score. Weights come from the dataset, or a uniform re-draw with
--redraw_weights. `--device` picks the card (default ``cuda``; ``cpu``
runs the plain PyTorch paths).

Usage (bash/train_gcn_dqn.sh recipe):
    python -m distgcn_tpu_torch.cli.train_dqn --datapath=data/..._train0 \\
        --test_datapath=data/..._test1 --num_layer=20 --hidden1=32 \\
        --feature_size=1 --diver_num=1 --learning_rate=1e-4 --epsilon=0.2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from distgcn_tpu_torch.agents_extra import LegacyDQNAgent
from distgcn_tpu_torch.data.matio import list_dataset, load_dataset_cached
from distgcn_tpu_torch.solvers.greedy import greedy_search
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.directory import find_model_folder


def _test_ratio(agent, test_insts) -> float:
    ratios = []
    for tinst in test_insts:
        _, g_u = greedy_search(tinst.adj, tinst.weights)
        _, u = agent.solve_mwis(tinst.adj, tinst.weights, train=False)
        ratios.append(u / g_u if g_u else 1.0)
    return float(np.mean(ratios))


def main(argv=None, agent=None, max_graphs_per_epoch=None):
    cfg = Config.from_args(argv)
    extra = argparse.ArgumentParser()
    extra.add_argument("--model_root", default="./model")
    extra.add_argument("--replay_every", type=int, default=200)
    extra.add_argument("--replay_batch", type=int, default=500)
    extra.add_argument("--redraw_weights", type=int, default=0)
    extra.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")
    ns, _ = extra.parse_known_args(argv)

    model_origin = find_model_folder(cfg, "dqn", ns.model_root)
    if agent is None:
        agent = LegacyDQNAgent(cfg, device=ns.device)
    agent.load(model_origin)

    train_files = list_dataset(cfg.datapath)
    train_insts = load_dataset_cached(cfg.datapath)
    test_insts = load_dataset_cached(cfg.test_datapath)

    rng = np.random.default_rng(cfg.seed)
    # a continuation run must not overwrite a better checkpoint with its
    # first mediocre eval: the gate starts at the loaded params' own score
    # (the reference's 0.55 gate assumes fresh training)
    best_ratio = 0.55
    if os.path.isfile(os.path.join(model_origin, "params.npz")):
        best_ratio = max(best_ratio, _test_ratio(agent, test_insts))
        print(f"checkpoint gate seeded at {best_ratio:.6f}", flush=True)
    loss_vec = []
    for epoch in range(cfg.epochs):
        losses, p_ratios = [], []
        cnt = 0
        newtime = time.time()
        order = rng.permutation(len(train_files))
        if max_graphs_per_epoch:
            order = order[:max_graphs_per_epoch]
        for gid in order:
            inst = train_insts[gid]
            wts = inst.weights.reshape(-1, 1)
            if ns.redraw_weights:
                wts = rng.uniform(0, 1, size=(inst.num_nodes, 1))
            _, greedy_util = greedy_search(inst.adj, wts)
            _, util = agent.solve_mwis(inst.adj, wts, train=True,
                                       grd=greedy_util)
            p_ratios.append(util / greedy_util if greedy_util else 1.0)
            if cnt < ns.replay_every - 1:
                cnt += 1
                continue
            cnt = 0
            runtime = time.time() - newtime
            newtime = time.time()
            test_ratio = _test_ratio(agent, test_insts)
            if test_ratio > best_ratio:
                agent.save(model_origin)
                best_ratio = test_ratio
            loss = agent.replay(ns.replay_batch)
            loss = 1.0 if loss is None else loss
            losses.append(loss)
            print(f"Epoch: {epoch} Train_Ratio: {np.mean(p_ratios):.6f} "
                  f"Epsilon: {agent.epsilon:.6f} "
                  f"Test_Ratio: {test_ratio:.6f} "
                  f"Loss: {loss:.6f} runtime: {runtime:.3f}")
            p_ratios = []
        loss_vec.append(np.mean(losses) if losses else np.nan)
    print(loss_vec)
    return best_ratio


if __name__ == "__main__":
    main()
