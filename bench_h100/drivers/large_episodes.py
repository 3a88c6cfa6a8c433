"""City-scale episodes: `make_large_closed_loop(graph, timeslots=T, ...)`'s
``run(params_list, queue0, generator)`` on one large conflict graph, a
T-slot episode a call, each from empty queues with its generator seeded
from (seed, episode index). With the GDPG features (feature_mode
'gdpg') the GCN runs once an episode and a slot is the draws, the LGS and
the queue update.

Set-up makes the graph from the seed and builds the port's `LargeGraph`
and parameters as `large_slots` does, then runs ``warmup_episodes``
episodes. The window runs whole episodes back to back, each ending in a
synchronise, until ``seconds`` have passed; it ends at an episode's end.
``slot_ms`` is the window's length over its slots (episodes x T). The
slots of an episode are not synchronised one by one, so no slot's own
time is taken.

The check replays episodes drawn from the seed among the window's first
``check_among`` (the same episodes whatever a version's speed; episode 0
where the window is shorter) with the plain reference (`reference.large`
at the configuration's stated precision, its GCN once an episode, the
generator's draws made again from the seed) and compares what the
program returns:

- ``links_off_share``: links whose final queue differs from the
  reference's, over real links (near-ties in the scores may flip, and a
  flip carries over the episode's later slots);
- ``util_gap``: the episode's mean scheduled utility against the
  reference's;
- ``queue_arith_off``: links whose final queue is not a whole number in
  [max(0, A - R), A], A the link's arrivals and R its rates summed over
  the episode (exact: a link never sends more than its rate, nor more
  than it holds).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import runtime
from bench_h100.drivers import large_slots
from bench_h100.reference import checkpoint, large, precision
from bench_h100.reference import traffic as ref_traffic
from bench_h100.trace import profiled

EPISODES, SAMPLE, WARMUP = 10, 11, 12       # seed streams (0-3: the graph)


def program(cell, adj, device):
    """(episode closure, LargeGraph, parameters) of the port."""
    from distgcn_tpu_torch.large import (build_large_graph,
                                         make_large_closed_loop,
                                         params_to_list)
    from distgcn_tpu_torch.utils.serialization import load_params

    m, t = cell.config["model"], cell.traffic
    g = build_large_graph(adj, block_size=cell.config["graph"]["block_size"],
                          use_bsr=True, device=device)
    plist = params_to_list(load_params(str(cell.path(
        cell.config["checkpoint"]))), device=device)
    episode = make_large_closed_loop(
        g, timeslots=t["timeslots"], load=t["load"], rate_lo=t["rate_lo"],
        rate_hi=t["rate_hi"], wt_sel=t["wt_sel"],
        feature_size=m["feature_size"], max_degree=m["max_degree"],
        predict=m["predict"], feature_mode=t["feature_mode"])
    return episode, g, plist


def picked(cell, seed) -> list:
    t = cell.traffic
    return sorted(int(i) for i in runtime.rng(seed, SAMPLE).choice(
        t["check_among"], size=t["check_episodes"], replace=False))


@precision.in_full_f32
def reference_episode(cell, ref_graph, forward, seed, i, device):
    """(final queues, mean scheduled utility, arrivals and rates summed
    over the episode) of episode i, plainly."""
    t = cell.traffic
    draws = ref_traffic.Draws(t["load"], t["rate_lo"], t["rate_hi"], device)
    gen = runtime.generator(device, seed, EPISODES, i)
    m = ref_graph.mask.to(torch.float32)
    act = forward(torch.ones((ref_graph.n, 1), device=device)
                  * m[:, None])[:, 0] * m

    def hoisted(x):
        return act[:, None]

    q = torch.zeros(ref_graph.n, device=device)
    a_sum, r_sum = torch.zeros_like(q), torch.zeros_like(q)
    utils = []
    for _ in range(t["timeslots"]):
        arrivals, rates = draws(gen, m)
        q, util, _, _ = large.slot(ref_graph, hoisted, q, arrivals, rates,
                                   t["wt_sel"])
        a_sum, r_sum = a_sum + arrivals, r_sum + rates
        utils.append(util)
    return q, torch.stack(utils).mean(), a_sum, r_sum


def compare(got, want) -> dict:
    (q, util), (rq, rutil, a_sum, r_sum) = got, want
    lo = torch.clamp(a_sum - r_sum, min=0.0)
    whole = q == torch.round(q)
    return {"links_off_share": int((q != rq).sum()) / rq.numel(),
            "util_gap": abs(float(util) - float(rutil))
            / max(abs(float(rutil)), 1.0),
            "queue_arith_off": int((~whole | (q < lo) | (q > a_sum)).sum())}


def _worst(readings) -> dict:
    return {key: max(r[key] for r in readings) for key in readings[0]}


def run(cell, seed, seconds, trace, device):
    from bench_h100 import harness

    t = cell.traffic
    phases = {"start": harness.process_age_s()}
    runtime.program_setup(device)
    phases["kernels"] = harness.process_age_s()
    adj = large_slots.make_graph(cell, seed)
    phases["inputs"] = harness.process_age_s()
    episode, g, plist = program(cell, adj, device)
    runtime.sync(device)
    phases["program"] = harness.process_age_s()
    q0 = torch.zeros(g.n_pad, device=device)
    for i in range(t["warmup_episodes"]):
        episode(plist, q0, runtime.generator(device, seed, WARMUP, i))
    runtime.sync(device)
    pick = picked(cell, seed)
    keep = set(pick) | {0}
    outs, count = {}, [0]

    def one():
        i = count[0]
        q, met = episode(plist, q0, runtime.generator(device, seed,
                                                      EPISODES, i))
        runtime.sync(device)
        if i in keep:
            outs[i] = (q, met["avg_utility"])
        count[0] += 1

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
    timed = count[0]
    slots = timed * t["timeslots"]
    res = {"e2e": {"setup_s": setup_s, "slot_ms": window_s / slots * 1e3},
           "attempted": slots, "setup_phases": phases,
           "compile_s": phases["kernels"] - phases["start"],
           "unit_s": runtime.summary(list(np.diff(marks))), "host": host}
    if trace:
        res["trace"] = profiled(t["trace_episodes"], one,
                                large_slots._counters if device == "cuda"
                                else None)
        res["work"] = dict(large_slots.work(cell, adj, timed, window_s),
                           slots_per_unit=t["timeslots"])
    res.update(runtime.device_facts(device))
    res["power_limit"] = harness.power_limit() if device == "cuda" else None
    n_pad = g.n_pad
    del episode, g, plist
    runtime.free(device)

    ref_graph = large.graph(adj, device)
    if ref_graph.n != n_pad:
        raise ValueError(f"graph of {ref_graph.n} links padded to {n_pad}: "
                         "the check compares unpadded graphs")
    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    forward = large_slots.forward_for(cell, ref_graph, layers)
    readings = [compare(outs[i], reference_episode(cell, ref_graph, forward,
                                                   seed, i, device))
                for i in [i for i in pick if i < timed] or [0]]
    worst = _worst(readings)
    res["failed"] = sum(r["queue_arith_off"] > 0 for r in readings)
    res["checks"] = [(name, worst[name], cell.limits[name])
                     for name in ("links_off_share", "util_gap",
                                  "queue_arith_off")]
    return res


def control(cell, seed, device) -> dict:
    """The reference at the control precision in the program's place, on
    the episodes a run checks, against the reference at the stated one."""
    adj = large_slots.make_graph(cell, seed)
    ref_graph = large.graph(adj, device)
    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    low = large_slots.forward_for(cell, ref_graph, layers,
                                  cell.config["precision"]["control"])
    stated = large_slots.forward_for(cell, ref_graph, layers)
    readings = []
    for i in picked(cell, seed):
        q, util, _, _ = reference_episode(cell, ref_graph, low, seed, i,
                                          device)
        readings.append(compare((q, util), reference_episode(
            cell, ref_graph, stated, seed, i, device)))
    return _worst(readings)
