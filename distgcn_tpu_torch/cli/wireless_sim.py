"""Wireless scheduling simulation CLI — port of
`distgcn_tpu/cli/wireless_sim.py` (the reference's `wireless_dqn_test.py`
single channel, `wireless_dqn_test_mc.py` multi-channel, and the `_flood`
fixed-load variants).

Usage (as scripts/test_wireless_gcn_dqn.sh, with the port's module):
    python -m distgcn_tpu_torch.cli.wireless_sim \\
        --test_datapath=data/wireless_test --wt_sel=qr --load_min=0.1 \\
        --load_max=1.0 --load_step=0.1 --num_channels=1 --opt=0 \\
        --training_set=ERGDPG2 --num_layer=20 --hidden1=32 \\
        --feature_size=1 --diver_num=1 --max_degree=1 --predict=mwis

Flood mode (fixed load 0.85, iterate instances): --flood=1. Per-slot online
training: --train=1 memorizes each slot and runs ``agent.replay(199)`` and
a save after each (load, instance).

Device-loop mode (--device_loop=1): every network is packed into one
padded batch and each load's whole T=200 episode (arrivals, queues,
utilities, GCN, LGS) runs on the device (`sim/device_sim`); `device_loop`
picks the loop: the single-channel loop with its greedy baseline, the
sequential loop on the per-channel graphs for --num_channels > 1 with
--opt=5 (DGCN-LGS-Seq) or --opt=7 (LGS-Seq), and the product graph
(`make_closed_loop_mc`) for any other opt. Traffic is drawn from a
``torch.Generator`` seeded with ``int(load * 1000)``, so per-slot streams
are not the host simulator's numpy streams (same distributions); the rows
carry the algo name 'DGCN-LGS-DL', 'DGCN-LGS-Seq-DL' or 'LGS-Seq-DL'.

The CSVs are written and read with the `csv` module in pandas' ``to_csv``
layout, so a sweep that one package began resumes under the other.
`--device` picks the card (default ``cuda``, which raises without one;
``cpu`` runs the plain PyTorch paths).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import scipy.io as sio
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.core.graph import pad_bucket
from distgcn_tpu_torch.data.wireless import (flows_from_connectivity,
                                             multichannel_conflict_graph,
                                             multichannel_conflict_simulate,
                                             pad_product_graph,
                                             poisson_graphs_from_dict)
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.sim.wireless import (ResumableResults, SimParams,
                                            algolist_for_opt, run_instance)
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.device import resolve_device
from distgcn_tpu_torch.utils.directory import find_model_folder

DEVICE_LOOP_SLOTS = 200
SEQ_OPTS = {5: "DGCN-LGS-Seq", 7: "LGS-Seq"}


def _extra_args(argv):
    extra = argparse.ArgumentParser()
    extra.add_argument("--model_root", default="./model")
    extra.add_argument("--flood", type=int, default=0)
    extra.add_argument("--benchmark", default="exact",
                       choices=["exact", "greedy"])
    extra.add_argument("--device_loop", type=int, default=0)
    # per-slot online training (wireless_dqn_test.py:339-344): memorize every
    # scheduled slot, replay(199) + checkpoint after each (load, instance)
    extra.add_argument("--train", type=int, default=0)
    extra.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")
    return extra.parse_known_args(argv)[0]


def _load_agent(cfg: Config, ns, device) -> DQNAgent:
    agent = DQNAgent(cfg, model_family="gcn_dqn", device=device)
    model_origin = find_model_folder(cfg, "dqn", ns.model_root)
    if not agent.load(model_origin):
        print(f"Unable to load {model_origin} — using current params")
    return agent


def _load_network(path: str):
    """(seed, adj_c, adj_i) of one `gdict` network file."""
    m = sio.loadmat(path)
    seed = int(np.asarray(m["random_seed"]).flatten()[0])
    adj_c, _, adj_i = poisson_graphs_from_dict(m["gdict"][0, 0])
    return seed, adj_c, adj_i


def _channel_graphs(adj_i, n_ch: int, seed: int) -> list:
    """A network's per-channel conflict graphs: each conflict edge kept
    with probability 0.8 per channel, drawn from the network's seed."""
    return multichannel_conflict_simulate(adj_i.toarray(), n_ch, 0.8,
                                          np.random.default_rng(seed))


def _avg_degree(graphs) -> float:
    """The mean over the channel graphs of their mean link degree, in
    float64 (sparse or dense graphs alike)."""
    return float(np.mean([np.asarray(g.sum(1), dtype=np.float64).mean()
                          for g in graphs]))


def _network_files(cfg: Config, max_networks: int):
    return sorted(f for f in os.listdir(cfg.test_datapath)
                  if f.endswith(".mat"))[:max_networks]


def _load_array(cfg: Config) -> list:
    return np.round(np.arange(cfg.load_min, cfg.load_max + cfg.load_step,
                              cfg.load_step), 2).tolist()


def main(argv=None, agent=None, max_networks: int = 20):
    cfg = Config.from_args(argv)
    ns = _extra_args(argv)
    device = resolve_device(ns.device)

    n_ch = cfg.num_channels
    params = SimParams(wt_sel=cfg.wt_sel, n_ch=n_ch, benchmark=ns.benchmark)
    algolist = algolist_for_opt(cfg.opt)

    if ns.device_loop:
        return main_device_loop(cfg, ns, agent, max_networks)

    model_origin = find_model_folder(cfg, "dqn", ns.model_root)
    if agent is None and any(a.startswith(("DGCN", "CGCN")) for a in algolist):
        agent = _load_agent(cfg, ns, device)

    out_csv = os.path.join(
        cfg.output,
        "metric_vs_load_summary_{}-channel_utility-{}_opt-{}_load-{:.1f}-{:.1f}{}.csv"
        .format(n_ch, cfg.wt_sel, cfg.opt, cfg.load_min, cfg.load_max,
                "_flood" if ns.flood else ""))
    results = ResumableResults(out_csv)

    if ns.flood:
        load_array = [0.85]
        inst_range = range(1, cfg.instances + 1)
    else:
        load_array = _load_array(cfg)
        inst_range = [1]

    for fname in _network_files(cfg, max_networks):
        seed, adj_c, adj_i = _load_network(os.path.join(cfg.test_datapath,
                                                        fname))
        nflows = len(flows_from_connectivity(adj_c))
        if nflows == 0:
            continue
        if n_ch > 1:
            graphs = _channel_graphs(adj_i, n_ch, seed)
            adj_list, adj_gk = multichannel_conflict_graph(graphs)
        else:
            adj_list, adj_gk = [adj_i], adj_i
        avg_degree = _avg_degree(adj_list)

        for load in load_array:
            for inst in inst_range:
                treeseed = inst if ns.flood else int(seed)
                if results.done(seed, treeseed, load):
                    continue
                t0 = time.time()
                metrics = run_instance(adj_gk, nflows, load, treeseed,
                                       algolist, params, agent, adj_list,
                                       train=bool(ns.train))
                if ns.train and agent is not None:
                    loss = agent.replay(199)
                    if loss is not None and not np.isnan(loss):
                        agent.save(model_origin)
                rows = []
                for algo, mvals in metrics.items():
                    row = {"graph": seed, "seed": treeseed, "load": load,
                           "name": algo, "avg_degree": avg_degree}
                    row.update(mvals)
                    rows.append(row)
                results.append(rows)
                lead = algolist[-1] if "Benchmark" not in algolist else \
                    [a for a in algolist if a != "Benchmark"][-1]
                print(f"net {seed} load {load} inst {inst}: "
                      f"q_mean[{lead}]={metrics[lead]['avg_queue_len']:.3f} "
                      f"u[{lead}]={metrics[lead]['avg_utility']:.3f} "
                      f"run={time.time()-t0:.2f}s")
    print("Done!")
    return results


def pack_networks(cfg: Config, max_networks: int = 20):
    """Every network of ``cfg.test_datapath`` in one padded batch.

    Returns (nets [(seed, nflows)], adj [B, n_ch*Nfp, n_ch*Nfp] float32,
    link_mask [B, Nfp] bool, adj_ch [B, n_ch, Nfp, Nfp] float32) as numpy
    arrays, the link count padded to `pad_bucket`'s multiple of 128: the
    product graph (`pad_product_graph`) when ``cfg.num_channels > 1``, and
    the per-channel conflict graphs it is built from (`_channel_graphs`;
    for one channel ``adj[:, None]``). Empty when no network has a link.
    """
    n_ch = cfg.num_channels
    nets, chans = [], []
    for fname in _network_files(cfg, max_networks):
        seed, _, adj_i = _load_network(os.path.join(cfg.test_datapath,
                                                    fname))
        nflows = adj_i.shape[0]
        if nflows == 0:
            continue
        chans.append(_channel_graphs(adj_i, n_ch, seed) if n_ch > 1
                     else [sp.csr_matrix(adj_i)])
        nets.append((seed, nflows))
    if not nets:
        return nets, None, None, None
    b = len(nets)
    nfp = pad_bucket(max(nf for _, nf in nets))
    link_mask = np.zeros((b, nfp), bool)
    adj_ch = np.zeros((b, n_ch, nfp, nfp), np.float32)
    for i, ((_, nf), graphs) in enumerate(zip(nets, chans)):
        link_mask[i, :nf] = True
        for c, g in enumerate(graphs):
            adj_ch[i, c, :nf, :nf] = g.toarray()
    if n_ch > 1:
        adj = np.stack([pad_product_graph(
            multichannel_conflict_graph(graphs)[1], nf, n_ch, nfp)
            for (_, nf), graphs in zip(nets, chans)])
    else:
        adj = adj_ch[:, 0]
    return nets, adj, link_mask, adj_ch


def _check_device_loop_opt(opt: int) -> None:
    if opt == 6:
        raise ValueError("--opt=6 (CGCN-RS-Seq) has no device loop: its "
                         "rollout search runs on the host engine only")


def device_loop(model, flags: Config, n_ch: int, opt: int, load: float,
                wt_sel: str = "qr", feature_mode: str = "gdpg",
                timeslots: int = DEVICE_LOOP_SLOTS):
    """The on-device episode that ``--device_loop=1`` runs at `load`:

    - one channel: `make_closed_loop` with the greedy baseline
      ('DGCN-LGS-DL', its utility the ratio to the baseline);
    - n_ch > 1 with opt 5 (DGCN-LGS-Seq) or 7 (LGS-Seq): the sequential
      loop `make_closed_loop_seq` on the per-channel graphs
      ('DGCN-LGS-Seq-DL', 'LGS-Seq-DL'; wt_sel 'qr' only);
    - any other opt: the product-graph loop `make_closed_loop_mc`
      ('DGCN-LGS-DL').

    Returns (row name, run, per_channel): ``run(adj, link_mask, queue0,
    generator)`` takes `pack_networks`'s per-channel graphs ``adj_ch``
    where `per_channel`, else its ``adj``. Raises ValueError for opt 6
    (CGCN-RS-Seq), whose rollout search has no device loop.
    """
    _check_device_loop_opt(opt)
    if n_ch == 1:
        return "DGCN-LGS-DL", device_sim.make_closed_loop(
            model, flags, timeslots=timeslots, load=load, wt_sel=wt_sel,
            feature_mode=feature_mode, with_baseline=True), False
    if opt in SEQ_OPTS:
        if wt_sel != "qr":
            raise ValueError(f"{SEQ_OPTS[opt]} takes wt_sel='qr', not "
                             f"{wt_sel!r}")
        return f"{SEQ_OPTS[opt]}-DL", device_sim.make_closed_loop_seq(
            model, flags, timeslots=timeslots, n_ch=n_ch, load=load,
            feature_mode=feature_mode, use_gcn=opt == 5), True
    return "DGCN-LGS-DL", device_sim.make_closed_loop_mc(
        model, flags, timeslots=timeslots, n_ch=n_ch, load=load,
        wt_sel=wt_sel, feature_mode=feature_mode), False


def main_device_loop(cfg, ns, agent=None, max_networks: int = 20):
    """All networks in one padded batch; one on-device episode per load."""
    n_ch = cfg.num_channels
    _check_device_loop_opt(cfg.opt)
    if agent is None:
        agent = _load_agent(cfg, ns, resolve_device(ns.device))
    dev = agent.device
    nets, adj, link_mask, adj_ch = pack_networks(cfg, max_networks)
    if not nets:
        print("No networks found")
        return None
    b, nfp = link_mask.shape
    degrees = [_avg_degree(adj_ch[i, :, :nf, :nf])
               for i, (_, nf) in enumerate(nets)]
    mask = torch.from_numpy(link_mask).to(dev)

    out_csv = os.path.join(
        cfg.output,
        "metric_vs_load_summary_{}-channel_utility-{}_deviceloop.csv"
        .format(n_ch, cfg.wt_sel))
    results = ResumableResults(out_csv)
    T = DEVICE_LOOP_SLOTS
    graphs = None
    for load in _load_array(cfg):
        if all(results.done(seed, seed, load) for seed, _ in nets):
            continue
        t0 = time.time()
        name, run, per_channel = device_loop(
            agent.model, agent.flags, n_ch, cfg.opt, load, cfg.wt_sel,
            agent.feature_mode, T)
        if graphs is None:
            graphs = torch.from_numpy(adj_ch if per_channel else adj).to(dev)
        q0 = torch.zeros((b, nfp), device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(load * 1000))
        _, metrics = run(graphs, mask, q0, gen)
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        rows = []
        for i, (seed, _) in enumerate(nets):
            if results.done(seed, seed, load):
                continue
            # column-semantics divergence (documented): the reference's
            # summary CSV stores the per-load tree seed here
            # (wireless_dqn_test.py treeseed=i); the device-loop rows
            # repeat the graph seed instead — resume keys include `load`,
            # so resumability is unaffected, but the column is not
            # byte-compatible with the reference format for these rows
            row = {"graph": seed, "seed": seed, "load": load,
                   "name": name, "avg_degree": degrees[i],
                   "avg_queue_len": float(metrics["avg_queue_len"][i]),
                   "med_queue_len": 0.0, "95p_queue_len": 0.0,
                   "5p_queue_len": 0.0,
                   "avg_utility": float(metrics.get(
                       "avg_utility_ratio", metrics["avg_utility"])[i])}
            rows.append(row)
        if rows:
            results.append(rows)
        wall = max(time.time() - t0, 1e-9)
        print(f"load {load}: {b} nets x {T} slots in {wall:.2f}s "
              f"({b * T / wall:,.0f} decisions/s)")
    print("Done!")
    return results


if __name__ == "__main__":
    main()
