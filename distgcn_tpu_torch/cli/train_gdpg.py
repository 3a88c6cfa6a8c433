"""GDPG training driver — port of `distgcn_tpu/cli/train_gdpg.py`
(the reference's `mwis_gdpg_train.py`).

Loop parity:
- epoch over shuffled training .mats, weights re-randomized U(0,1) per graph
  (mwis_gdpg_train.py:94 — this is the GDPG exploration mechanism);
- solve_mwis(train=True, grd=greedy_util) memorizes reward = util/greedy;
- every `replay_every` graphs: evaluate on the test set, checkpoint when the
  mean test ratio beats the best so far (init 0.55, :151-153), replay(200);
- epsilon reset x0.2 at epochs {5, 10, 15, 20} (:77, 175-177).

`--device_batch=B` solves B graphs per device batch through
`pipeline.make_train_pipeline` (two LGS launches per batch); without it,
each graph is one `solve_mwis` (one LGS launch). `--device` picks the card
(default ``cuda``; ``cpu`` runs the plain PyTorch paths). The checkpoint
gate writes ``params.npz`` into the model folder under `--model_root`.

Usage:
    python -m distgcn_tpu_torch.cli.train_gdpg --datapath=data/..._train0 \\
        --test_datapath=data/..._test1 --num_layer=1 --hidden1=32 \\
        --feature_size=1 --diver_num=1 --learning_rate=1e-5 --epochs=25 \\
        --device_batch=128
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.data.matio import (list_dataset, load_dataset_cached,
                                          load_mat)
from distgcn_tpu_torch.pipeline import BatchedEvaluator, make_train_pipeline
from distgcn_tpu_torch.solvers.greedy import greedy_search
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.directory import find_model_folder


EPSILON_RESETS = frozenset({5, 10, 15, 20})


def schedule_epsilon(start_epoch: int) -> float:
    """Epsilon-reset schedule state at `start_epoch` of the 25-epoch
    recipe: x0.2 applied after epochs {5, 10, 15, 20}
    (mwis_gdpg_train.py:77,175-177)."""
    return 0.2 ** sum(1 for r in EPSILON_RESETS if r <= start_epoch)


def _extra_args(argv):
    extra = argparse.ArgumentParser()
    extra.add_argument("--model_root", default="./model")
    extra.add_argument("--replay_every", type=int, default=200)
    extra.add_argument("--replay_batch", type=int, default=200)
    extra.add_argument("--target_style", default="gdpg",
                       choices=["gdpg", "dqn", "dqn_origin"],
                       help="replay targets: gdpg = act_vals[sol]+=reward "
                            "then batch-standardize (mwis_gdpg_call.py:740-"
                            "757); dqn = bounded assignment act_vals[sol]="
                            "reward (mwis_dqn_call.py:168-171); dqn_origin "
                            "= reward + per-node w/greedy term "
                            "(mwis_dqn_origin.py:216). Read by the batched "
                            "trainer, as in the JAX package")
    extra.add_argument("--device_batch", type=int, default=0,
                       help=">0: solve device_batch graphs per device batch "
                            "instead of the reference's one-graph loop")
    extra.add_argument("--model_family", default="gcn2_dqn",
                       choices=["gcn2_dqn", "gcn_dqn"],
                       help="gcn2_dqn = GCN2_DQN (GDPG agent's model, "
                            "mwis_gdpg_call.py:666-669); gcn_dqn = GCN_DQN "
                            "(the family of the reference's IS4SAT zoo)")
    extra.add_argument("--start_epoch", type=int, default=0,
                       help="resume the 25-epoch recipe at this epoch with "
                            "the reference's epsilon-reset schedule state "
                            "restored (mwis_gdpg_train.py:77,175-177)")
    extra.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")
    ns, _ = extra.parse_known_args(argv)
    return ns


def main(argv=None, agent=None, max_graphs_per_epoch=None):
    cfg = Config.from_args(argv)
    ns = _extra_args(argv)
    if ns.device_batch > 0:
        return main_batched(cfg, ns, agent, max_graphs_per_epoch)

    model_origin = find_model_folder(cfg, "dqn", ns.model_root)
    if agent is None:
        agent = DQNAgent(cfg, model_family=ns.model_family, device=ns.device)
    agent.load(model_origin)

    train_files = list_dataset(cfg.datapath)
    test_files = list_dataset(cfg.test_datapath)
    test_insts = [load_mat(os.path.join(cfg.test_datapath, f))
                  for f in test_files]

    rng = np.random.default_rng(cfg.seed)
    epsilon_val = 1.0
    if ns.start_epoch:
        # restore the reset-schedule state and burn the per-epoch shuffle
        # draws. APPROXIMATE: an uninterrupted run also consumes rng
        # entropy per graph, so resumed epochs see different orderings;
        # the epsilon-schedule state is exact
        epsilon_val = schedule_epsilon(ns.start_epoch)
        agent.epsilon = epsilon_val
        for _ in range(ns.start_epoch):
            rng.permutation(len(train_files))
    best_ratio = 0.55
    loss_vec = []

    for epoch in range(ns.start_epoch, cfg.epochs):
        losses, p_ratios = [], []
        cnt = 0
        newtime = time.time()
        order = rng.permutation(len(train_files))
        if max_graphs_per_epoch:
            order = order[:max_graphs_per_epoch]
        for gid in order:
            inst = load_mat(os.path.join(cfg.datapath, train_files[gid]))
            wts = rng.uniform(0, 1, size=(inst.num_nodes, 1))
            _, greedy_util = greedy_search(inst.adj, wts)
            _, ss_util = agent.solve_mwis(inst.adj, wts, train=True,
                                          grd=greedy_util)
            p_ratios.append(ss_util / greedy_util if greedy_util else 1.0)
            if cnt < ns.replay_every - 1:
                cnt += 1
                continue
            cnt = 0
            runtime = time.time() - newtime
            newtime = time.time()
            test_ratio = []
            for tinst in test_insts:
                _, g_u = greedy_search(tinst.adj, tinst.weights)
                _, u = agent.solve_mwis(tinst.adj, tinst.weights, train=False)
                test_ratio.append(u / g_u if g_u else 1.0)
            if np.mean(test_ratio) > best_ratio:
                agent.save(model_origin)
                best_ratio = float(np.mean(test_ratio))
            loss = agent.replay(ns.replay_batch)
            loss = 1.0 if loss is None else loss
            losses.append(loss)
            print(f"Epoch: {epoch} Train_Ratio: {np.mean(p_ratios):.6f} "
                  f"Epsilon: {agent.epsilon:.6f} "
                  f"Test_Ratio: {np.mean(test_ratio):.6f} "
                  f"Loss: {loss:.6f} runtime: {runtime:.3f} "
                  f"mem_val: {np.nanmean(agent.reward_mem):.3f}")
            p_ratios = []
        loss_vec.append(np.mean(losses) if losses else np.nan)
        if epoch + 1 in EPSILON_RESETS:
            epsilon_val *= 0.2
            agent.epsilon = epsilon_val
    print(loss_vec)
    return best_ratio


def main_batched(cfg, ns, agent=None, max_graphs_per_epoch=None):
    """Batched GDPG training: the reference loop's learning semantics —
    per-graph reward = LGS(gcn weights)/greedy, memorize, replay every
    `replay_every` graphs with test-gated checkpoints — with `device_batch`
    graphs solved per `make_train_pipeline` call, the greedy baseline from
    the same call. `sel`, `util`, `gutil` and `acts` are read back once
    per batch."""
    model_origin = find_model_folder(cfg, "dqn", ns.model_root)
    if agent is None:
        agent = DQNAgent(cfg, model_family=ns.model_family, device=ns.device)
    dev = agent.device
    if ns.target_style != "gdpg":
        agent.trainer.style = ns.target_style
    agent.load(model_origin)
    pipe = make_train_pipeline(agent.model, agent.flags, agent.feature_mode)
    ev = BatchedEvaluator(agent, batch_size=max(ns.device_batch, 32),
                          device=dev)

    test_insts = load_dataset_cached(cfg.test_datapath)
    test_pairs = [(i.adj, i.weights) for i in test_insts]
    t0 = time.time()
    adjs = [inst.adj for inst in load_dataset_cached(cfg.datapath)]
    print(f"loaded {len(adjs)} train + {len(test_insts)} test graphs "
          f"in {time.time() - t0:.1f}s", flush=True)

    rng = np.random.default_rng(cfg.seed)
    epsilon_val = 1.0
    if ns.start_epoch:
        epsilon_val = schedule_epsilon(ns.start_epoch)
        agent.epsilon = epsilon_val
        for _ in range(ns.start_epoch):
            rng.permutation(len(adjs))
    # seed the checkpoint gate from the loaded params' own test score, so a
    # continuation run never overwrites a better checkpoint with its first
    # mediocre eval (the reference's 0.55 gate assumes fresh training)
    best_ratio = 0.55
    if os.path.isfile(os.path.join(model_origin, "params.npz")):
        u0, g0 = ev.evaluate(test_pairs)
        best_ratio = max(best_ratio,
                         float(np.mean(u0 / np.maximum(g0, 1e-9))))
        print(f"checkpoint gate seeded at {best_ratio:.6f}", flush=True)
    bs = ns.device_batch
    loss_vec = []
    for epoch in range(ns.start_epoch, cfg.epochs):
        order = rng.permutation(len(adjs))
        if max_graphs_per_epoch:
            order = order[:max_graphs_per_epoch]
        losses, p_ratios = [], []
        done = 0
        newtime = time.time()
        for start in range(0, len(order), bs):
            idx = order[start: start + bs]
            batch_adjs = [adjs[i] for i in idx]
            batch_wts = [rng.uniform(0, 1, size=a.shape[0])
                         for a in batch_adjs]
            n_max = max(a.shape[0] for a in batch_adjs)
            pad = -(-n_max // cfg.pad_to) * cfg.pad_to
            gb = GraphBatch.from_scipy(batch_adjs, batch_wts, pad_to=pad,
                                       device=dev)
            # GCN scores with the reference's epsilon-greedy value
            # exploration (mwis_gdpg_call.py:696-705) + LGS + greedy
            # baseline + the act_vals to memorize
            rand = rng.uniform(0, 1, size=tuple(gb.wts.shape)).astype(
                np.float32)
            explore = rng.uniform(size=len(idx)) <= agent.epsilon
            sel, util, gutil, acts = pipe(
                gb.adj, gb.wts, gb.mask, torch.from_numpy(rand).to(dev),
                torch.from_numpy(explore).to(dev))
            if epoch == 0 and start == 0:
                print(f"first batch solved (pad {pad}) "
                      f"{time.time() - newtime:.1f}s after epoch start",
                      flush=True)
            sel_h = sel.cpu().numpy()
            util_h = util.cpu().numpy()
            gutil_h = gutil.cpu().numpy()
            acts_h = acts.cpu().numpy()
            for j in range(len(idx)):
                n = batch_adjs[j].shape[0]
                reward = util_h[j] / (gutil_h[j] + 1e-6)
                solution = np.nonzero(sel_h[j, :n] == 1)[0].tolist()
                state = {"adj": batch_adjs[j],
                         "wts": batch_wts[j].astype(np.float32)}
                agent.memory.append((state, acts_h[j, :n, :].copy(),
                                     solution, {}, float(reward)))
                agent.reward_mem.append(float(reward))
                p_ratios.append(float(reward))
            done += len(idx)
            if done >= ns.replay_every:
                done = 0
                runtime = time.time() - newtime
                newtime = time.time()
                utils_t, gutils_t = ev.evaluate(test_pairs)
                test_ratio = float(np.mean(utils_t / np.maximum(gutils_t,
                                                                1e-9)))
                if test_ratio > best_ratio:
                    agent.save(model_origin)
                    best_ratio = test_ratio
                loss = agent.replay(min(ns.replay_batch, len(agent.memory)))
                loss = 1.0 if loss is None else loss
                losses.append(loss)
                print(f"Epoch: {epoch} Train_Ratio: {np.mean(p_ratios):.6f} "
                      f"Epsilon: {agent.epsilon:.6f} "
                      f"Test_Ratio: {test_ratio:.6f} Loss: {loss:.6f} "
                      f"runtime: {runtime:.3f} "
                      f"mem_val: {np.nanmean(agent.reward_mem):.3f}",
                      flush=True)
                p_ratios = []
        loss_vec.append(np.mean(losses) if losses else np.nan)
        if epoch + 1 in EPSILON_RESETS:
            epsilon_val *= 0.2
            agent.epsilon = epsilon_val
    print(loss_vec)
    return best_ratio


if __name__ == "__main__":
    main()
