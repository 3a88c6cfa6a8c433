"""City-scale slots: `make_large_closed_loop(graph, timeslots=1, ...)`'s
``run(params_list, queue, generator)`` called once a slot on one large
conflict graph, the queues and the generator carried from slot to slot.

Set-up makes the graph from the seed (a weighted copy when the
configuration's graph names ``edge_weights``), builds the port's
`LargeGraph` on the card (structure blocks, and the edge form of a
weighted graph), loads the checkpoint and runs ``warmup_slots`` slots
from empty queues. The window runs slots, each timed on the host clock
from its call to its synchronise, until ``seconds`` have passed:
``slot_ms`` is the window's length over its slots, ``slot_ms_p95`` the
95th percentile of the slots' times.

The check follows the program from its own state: for the first slot
(from the empty queues set-up made) and a sample of the window's slots
drawn from the seed, the plain reference (`reference.large`) computes
the slot from the queues the program started it with and from the
generator's draws made again from the seed, and compares:

- ``links_off_share``: links whose queue after the slot differs from the
  reference's, over real links (near-ties in the scores may flip);
- ``util_gap``: the slot's scheduled utility against the reference's;
- ``queue_arith_off``: links whose new queue is neither q nor
  q - min(q, rate) for q = old queue + arrivals (exact);
- ``conflicts``: conflicting pairs of links that both sent (exact).
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_h100 import graphs, runtime
from bench_h100.counts import gcn, kernels
from bench_h100.reference import checkpoint, large, precision
from bench_h100.reference import traffic as ref_traffic
from bench_h100.trace import profiled

GRAPH, WEIGHTS, SLOTS, SAMPLE = 0, 1, 2, 3              # seed streams


def make_graph(cell, seed):
    """The host adjacency (scipy csr) of this run."""
    g = cell.config["graph"]
    w = g.get("edge_weights")
    adj = graphs.geometric(runtime.rng(seed, GRAPH), g["n"],
                           g["avg_degree"], g["order"])
    if w:
        adj = graphs.weighted_copy(runtime.rng(seed, WEIGHTS), adj,
                                   w["lo"], w["hi"])
    return adj


def program(cell, adj, device):
    """(one-slot closure, LargeGraph, parameters) of the port."""
    from distgcn_tpu_torch.large import (build_large_graph,
                                         make_large_closed_loop,
                                         params_to_list)
    from distgcn_tpu_torch.utils.serialization import load_params

    m, t = cell.config["model"], cell.traffic
    g = build_large_graph(adj, block_size=cell.config["graph"]["block_size"],
                          use_bsr=True, device=device)
    plist = params_to_list(load_params(str(cell.path(
        cell.config["checkpoint"]))), device=device)
    step = make_large_closed_loop(
        g, timeslots=1, load=t["load"], rate_lo=t["rate_lo"],
        rate_hi=t["rate_hi"], wt_sel=t["wt_sel"],
        feature_size=m["feature_size"], max_degree=m["max_degree"],
        predict=m["predict"], feature_mode=t["feature_mode"])
    return step, g, plist


def _counters():
    from distgcn_tpu_torch.ops.nbr_max_cuda import bsr_nbr_max_kernel
    return {"nbr_max_launches": bsr_nbr_max_kernel.launches}


def work(cell, adj, timed_slots, timed_s) -> dict:
    m = cell.config["model"]
    dims = gcn.widths(m["feature_size"], m["hidden1"], m["num_layer"])
    n, nnz = adj.shape[0], adj.nnz
    blocks = kernels.structure_blocks(adj)
    layers = list(zip(dims[:-1], dims[1:]))
    fused = [kernels.fused_layer_bound_s(blocks, n, nnz, fi, fo,
                                         i == len(layers) - 1)
             for i, (fi, fo) in enumerate(layers)]
    spmm = [kernels.edge_spmm_bound_s(blocks, n, nnz, fo)
            for _, fo in layers]
    return {"slots_per_unit": 1,
            "gcn_flops": gcn.forward_flops(n, nnz, dims) * timed_slots,
            "timed_s": timed_s, "timed_units": timed_slots,
            "kernels": {
                "cheb_fused": {"match": "fused_layer_kernel",
                               "bound_s": sum(fused) / len(fused)},
                "edge_spmm": {"match": "bsr_spmm_kernel",
                              "bound_s": sum(spmm) / len(spmm)},
                "nbr_max": {"match": "nbr_max_bitmap_kernel",
                            "bound_s": kernels.nbr_max_bound_s(blocks, n,
                                                               nnz)}}}


class Replay:
    """The generator's draws slot by slot, made again from the seed."""

    def __init__(self, cell, seed, n, device):
        t = cell.traffic
        self.draws = ref_traffic.Draws(t["load"], t["rate_lo"],
                                       t["rate_hi"], device)
        self.gen = runtime.generator(device, seed, SLOTS)
        self.m = torch.ones(n, device=device)
        self.t = 0

    def at(self, t: int):
        if t < self.t:
            raise ValueError("slots are replayed in order")
        while self.t < t:
            self.draws(self.gen, self.m)
            self.t += 1
        self.t += 1
        return self.draws(self.gen, self.m)


def forward_for(cell, ref_graph, layers, fmt=None):
    """The reference forward of the configuration's route at its stated
    precision, or at `fmt`."""
    if cell.config["precision"]["route"] == "exact":
        mm = precision.rounder(fmt or "float32")
        return lambda x: large.forward_exact(ref_graph, layers, x, mm)
    rnd = precision.rounder(fmt or "bfloat16")
    return lambda x: large.forward_fused(ref_graph, layers, x, rnd)


def compare(ref_graph, forward, replay, records, wt_sel) -> dict:
    """The check's numbers over `records` of (t, q_before, q_after, util),
    sorted by t."""
    n = ref_graph.n
    worst = {"links_off_share": 0.0, "util_gap": 0.0, "queue_arith_off": 0,
             "conflicts": 0}
    bad_slots = 0
    for t, q_prev, q_new, util in records:
        arrivals, rates = replay.at(t)
        rq, rutil, _, _ = large.slot(ref_graph, forward, q_prev, arrivals,
                                     rates, wt_sel)
        q = q_prev + arrivals
        legal = (q_new == q) | (q_new == q - torch.minimum(q, rates))
        sent = q_new < q
        pairs = (ref_graph.valid & sent[:, None] & sent[ref_graph.nbr])
        got = {"links_off_share": int((q_new != rq).sum()) / n,
               "util_gap": abs(float(util) - float(rutil))
               / max(abs(float(rutil)), 1.0),
               "queue_arith_off": int((~legal).sum()),
               "conflicts": int(pairs.sum()) // 2}
        bad_slots += got["queue_arith_off"] > 0 or got["conflicts"] > 0 \
            or q_new.shape != rq.shape
        for key, value in got.items():
            worst[key] = max(worst[key], value)
    worst["_bad_slots"] = bad_slots
    return worst


def run(cell, seed, seconds, trace, device):
    from bench_h100 import harness

    phases = {"start": harness.process_age_s()}
    runtime.program_setup(device)
    phases["kernels"] = harness.process_age_s()
    adj = make_graph(cell, seed)
    phases["inputs"] = harness.process_age_s()
    step, g, plist = program(cell, adj, device)
    runtime.sync(device)
    phases["program"] = harness.process_age_s()
    gen = runtime.generator(device, seed, SLOTS)
    state = SimpleNamespace(q=torch.zeros(g.n_pad, device=device), t=0)
    k = cell.traffic["check_slots"]
    sample = random.Random(runtime.seed_int(seed, SAMPLE))
    kept, seen = [], 0
    times = []

    def one(record=None):
        q_prev = state.q
        state.q, met = step(plist, q_prev, gen)
        runtime.sync(device)
        if record is not None:
            record((state.t, q_prev, state.q, met["avg_utility"]))
        state.t += 1

    def reservoir(rec):
        nonlocal seen
        if len(kept) < k:
            kept.append(rec)
        else:
            j = sample.randrange(seen + 1)
            if j < k:
                kept[j] = rec
        seen += 1

    first = []
    one(first.append)
    for _ in range(cell.traffic["warmup_slots"] - 1):
        one()
    setup_s = harness.process_age_s()
    host = runtime.HostWatch().start()
    t0 = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        one(reservoir)
        times.append(time.perf_counter() - s0)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    host = host.stop()
    res = {"e2e": {"setup_s": setup_s,
                   "slot_ms": window_s / len(times) * 1e3,
                   "slot_ms_p95": float(np.percentile(times, 95)) * 1e3},
           "attempted": len(times), "setup_phases": phases,
           "compile_s": phases["kernels"] - phases["start"],
           "unit_s": runtime.summary(times), "host": host}
    if trace:
        res["trace"] = profiled(cell.traffic["trace_slots"], one,
                                _counters if device == "cuda" else None)
        res["work"] = work(cell, adj, len(times), window_s)
    res.update(runtime.device_facts(device))
    res["power_limit"] = harness.power_limit() if device == "cuda" else None
    n_pad = g.n_pad
    del step, g, plist, gen
    runtime.free(device)

    ref_graph = large.graph(adj, device)
    if ref_graph.n != n_pad:
        raise ValueError(f"graph of {ref_graph.n} links padded to {n_pad}: "
                         "the check compares unpadded graphs")
    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    records = first + sorted(kept, key=lambda r: r[0])
    worst = compare(ref_graph, forward_for(cell, ref_graph, layers),
                    Replay(cell, seed, ref_graph.n, device), records,
                    cell.traffic["wt_sel"])
    res["failed"] = worst.pop("_bad_slots")
    res["checks"] = [(name, worst[name], cell.limits[name])
                     for name in ("links_off_share", "util_gap",
                                  "queue_arith_off", "conflicts")]
    return res


def control(cell, seed, device, slots: int = 64) -> dict:
    """The reference at the control precision in the program's place, for
    `slots` slots from empty queues, checked as a run checks the program:
    the first slot and a sample of the rest."""
    adj = make_graph(cell, seed)
    ref_graph = large.graph(adj, device)
    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    fwd_low = forward_for(cell, ref_graph, layers,
                          cell.config["precision"]["control"])
    replay = Replay(cell, seed, ref_graph.n, device)
    pick = set(random.Random(runtime.seed_int(seed, SAMPLE)).sample(
        range(1, slots), min(cell.traffic["check_slots"], slots - 1)))
    q = torch.zeros(ref_graph.n, device=device)
    records = []
    for t in range(slots):
        arrivals, rates = replay.at(t)
        q_new, util, _, _ = large.slot(ref_graph, fwd_low, q, arrivals,
                                       rates, cell.traffic["wt_sel"])
        if t == 0 or t in pick:
            records.append((t, q, q_new, util))
        q = q_new
    worst = compare(ref_graph, forward_for(cell, ref_graph, layers),
                    Replay(cell, seed, ref_graph.n, device), records,
                    cell.traffic["wt_sel"])
    worst.pop("_bad_slots")
    return worst
