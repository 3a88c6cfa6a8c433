"""The TWC paper's wireless evaluation on the device loop: the
repository's Poisson networks (`data/wireless_test`) in one padded batch
(`cli.wireless_sim.pack_networks`), and the loop that
``wireless_sim --device_loop=1`` runs for the traffic's channels and
``opt`` (`cli.wireless_sim.device_loop`): one channel, the dense loop
with its greedy baseline; several channels with opt 5 or 7, the
sequential loop on the per-channel graphs.

Set-up loads the networks, the checkpoint into the port's ChebGCN, makes
one loop a load and runs a short episode of each. A unit is one T-slot
episode at each of the traffic's loads, each from empty queues with its
generator seeded from (seed, unit, load index), each ending in a
synchronise. The window runs whole units back to back until ``seconds``
have passed. ``decisions_per_s`` is networks x slots of the window's
units over the window's length.

The check runs the plain reference (`reference.wireless`) over
``check_episodes`` episodes drawn from the seed among the window's first
``check_among`` units (so versions at different speeds check the same
episodes), on the same graphs and generator seeds, and counts the
networks whose final queues or whose per-network metrics differ in any
bit (`graphs_off`).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_h100 import runtime
from bench_h100.counts import gcn, kernels
from bench_h100.reference import checkpoint, precision, wireless
from bench_h100.reference import traffic as ref_traffic
from bench_h100.trace import profiled

EPISODES, SAMPLE, WARMUP = 1, 2, 3                  # seed streams


def flags(cell):
    from distgcn_tpu_torch.utils.config import Config

    m, nw, t = cell.config["model"], cell.config["networks"], cell.traffic
    return Config(feature_size=m["feature_size"], hidden1=m["hidden1"],
                  num_layer=m["num_layer"], diver_num=m["diver_num"],
                  max_degree=m["max_degree"], predict=m["predict"],
                  pad_to=nw["pad_to"], batch_size=nw["count"],
                  compute_dtype="float32", num_channels=t["n_ch"],
                  opt=t["opt"], wt_sel=t["wt_sel"],
                  test_datapath=str(cell.path(nw["path"])))


def inputs(cell, device) -> SimpleNamespace:
    """The networks in one batch, on `device`: the graphs the loop takes,
    the per-channel graphs, the link mask, and per network its links and
    each channel's directed conflicts."""
    from distgcn_tpu_torch.cli import wireless_sim

    nw = cell.config["networks"]
    nets, _, mask, adj_ch = wireless_sim.pack_networks(flags(cell),
                                                       nw["count"])
    if len(nets) != nw["count"] or mask.shape[1] != nw["pad_to"]:
        raise ValueError(f"{len(nets)} networks padded to {mask.shape[1]}, "
                         f"the configuration states {nw['count']} and "
                         f"{nw['pad_to']}")
    return SimpleNamespace(
        adj_ch=torch.from_numpy(adj_ch).to(device),
        mask=torch.from_numpy(mask).to(device),
        ns=[nf for _, nf in nets],
        es=[[int(np.count_nonzero(adj_ch[i, c])) for c in
             range(adj_ch.shape[1])] for i in range(len(nets))])


def unit_flops(cell, inp) -> int:
    """Model FLOPs of a unit's GCN forwards. One channel: one forward an
    episode (gdpg). The sequential loop: one forward a slot and channel,
    each counted at its channel graph's real links and conflicts, an
    upper bound of the subgraph the forward scores."""
    m, t = cell.config["model"], cell.traffic
    if t["n_ch"] > 1 and t["opt"] == 7:
        return 0
    dims = gcn.widths(m["feature_size"], m["hidden1"], m["num_layer"])
    per_episode = sum(gcn.forward_flops(n, e, dims)
                      for n, es in zip(inp.ns, inp.es) for e in es)
    if t["n_ch"] > 1:
        per_episode *= t["timeslots"]
    return per_episode * len(t["loads"])


def program(cell, device):
    """[(run, per_channel)] a load, and the same loops of the warm-up's
    length, from the shared routing of the CLI's device loop."""
    from distgcn_tpu_torch.cli.wireless_sim import device_loop
    from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                              params_from_jax)
    from distgcn_tpu_torch.utils.serialization import load_params

    cfg, t = flags(cell), cell.traffic
    params = params_from_jax(load_params(str(cell.path(
        cell.config["checkpoint"]))))
    model = make_model_from_config(cfg, cell.config["model"]["family"],
                                   params=params, device=device)

    def loops(timeslots):
        out = []
        for load in t["loads"]:
            _, run, per_channel = device_loop(
                model, cfg, t["n_ch"], t["opt"], load, t["wt_sel"],
                t["feature_mode"], timeslots)
            out.append((run, per_channel))
        return out

    return loops(t["timeslots"]), loops(t["warmup_slots"])


def _graphs(inp, per_channel):
    return inp.adj_ch if per_channel else inp.adj_ch[:, 0]


def reference_episode(cell, layers, inp, seed, unit, li, device, mm=None):
    t = cell.traffic
    gen = runtime.generator(device, seed, EPISODES, unit, li)
    mm = mm or (lambda x: x)
    if t["n_ch"] == 1:
        draws = ref_traffic.Draws(t["loads"][li], t["rate_lo"],
                                  t["rate_hi"], device)
        return wireless.episode_single(layers, inp.adj_ch[:, 0], inp.mask,
                                       gen, t["timeslots"], draws, mm=mm)
    draws = wireless.ChannelDraws(t["loads"][li], t["rate_lo"], t["rate_hi"],
                                  t["n_ch"], device)
    return wireless.episode_seq(layers, inp.adj_ch, inp.mask, gen,
                                t["timeslots"], draws,
                                use_gcn=t["opt"] == 5, mm=mm)


def graphs_off(got, want) -> int:
    """Networks whose final queues or metrics differ in any bit."""
    (q, met), (rq, rmet) = got, want
    bad = (q != rq).any(dim=-1)
    if set(met) != set(rmet):
        return int(q.shape[0])
    for key, value in rmet.items():
        bad |= met[key] != value
    return int(bad.sum())


def run(cell, seed, seconds, trace, device):
    from bench_h100 import harness
    # a program without the shared routing fails here, before any set-up
    from distgcn_tpu_torch.cli.wireless_sim import device_loop  # noqa: F401

    t = cell.traffic
    phases = {"start": harness.process_age_s()}
    runtime.program_setup(device)
    phases["kernels"] = harness.process_age_s()
    inp = inputs(cell, device)
    phases["inputs"] = harness.process_age_s()
    episodes, warm = program(cell, device)
    phases["program"] = harness.process_age_s()
    b, n = inp.mask.shape
    q0 = torch.zeros((b, n), device=device)
    for li, (loop, per_channel) in enumerate(warm):
        loop(_graphs(inp, per_channel), inp.mask, q0,
             runtime.generator(device, seed, WARMUP, li))
    runtime.sync(device)
    outs = []

    def one():
        unit = len(outs)
        got = []
        for li, (loop, per_channel) in enumerate(episodes):
            got.append(loop(_graphs(inp, per_channel), inp.mask, q0,
                            runtime.generator(device, seed, EPISODES, unit,
                                              li)))
            runtime.sync(device)
        outs.append(got)

    setup_s = harness.process_age_s()
    host = runtime.HostWatch().start()
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        one()
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds:
            break
    window_s = marks[-1] - t0
    host = host.stop()
    timed = len(outs)
    slots = t["timeslots"] * len(t["loads"])
    res = {"e2e": {"setup_s": setup_s,
                   "decisions_per_s": timed * b * slots / window_s},
           "attempted": timed * len(t["loads"]) * b, "setup_phases": phases,
           "compile_s": phases["kernels"] - phases["start"],
           "unit_s": runtime.summary(list(np.diff(marks))), "host": host}
    if trace:
        res["trace"] = profiled(t["trace_units"], one)
        res["work"] = {
            "slots_per_unit": slots,
            "gcn_flops": unit_flops(cell, inp) * timed,
            "timed_s": window_s, "timed_units": timed,
            "kernels": {"lgs": {"match": "lgs_kernel",
                                "bound_s": kernels.lgs_bound_s(b, n)}}}
    res.update(runtime.device_facts(device))
    res["power_limit"] = harness.power_limit() if device == "cuda" else None
    del episodes, warm
    runtime.free(device)

    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    among = min(t["check_among"], timed) * len(t["loads"])
    k = min(t["check_episodes"], among)
    pick = sorted(runtime.rng(seed, SAMPLE).choice(among, size=k,
                                                   replace=False))
    off = 0
    for i in pick:
        unit, li = divmod(int(i), len(t["loads"]))
        off += graphs_off(outs[unit][li], reference_episode(
            cell, layers, inp, seed, unit, li, device))
    res["failed"] = off
    res["checks"] = [("graphs_off", off, cell.limits["graphs_off"])]
    return res


def control(cell, seed, device) -> dict:
    """The reference in the program's place at the control precision (one
    step below the stated one), against the reference at the stated one,
    over as many episodes as a run checks (the first units' episodes)."""
    inp = inputs(cell, device)
    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    mm = precision.rounder(cell.config["precision"]["control"])
    n_loads = len(cell.traffic["loads"])
    off = 0
    for i in range(cell.traffic["check_episodes"]):
        unit, li = divmod(i, n_loads)
        want = reference_episode(cell, layers, inp, seed, unit, li, device)
        got = reference_episode(cell, layers, inp, seed, unit, li, device,
                                mm=mm)
        off += graphs_off(got, want)
    return {"graphs_off": off}
