"""Dense closed-loop episodes: `make_closed_loop(...)`'s
``run(adj, mask, queue0, generator)`` on one resident batch of padded
conflict graphs.

Set-up makes the batch from the seed, loads the checkpoint into the
port's ChebGCN and runs a short episode of the same shapes. The window
runs whole episodes back to back, each from empty queues with its
generator seeded from (seed, episode index), each ending in a
synchronise, until ``seconds`` have passed; it ends at an episode's end.
``decisions_per_s`` is graphs x slots of the window's episodes over the
window's length.

The check runs the plain reference (`reference.dense`) over a sample of
the window's episodes, drawn from the seed, on the same graphs and the
same generator seeds, and counts the graphs whose final queues or whose
three per-graph metrics differ in any bit (`graphs_off`).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_h100 import graphs, runtime
from bench_h100.counts import gcn, kernels
from bench_h100.reference import checkpoint, dense, precision
from bench_h100.reference import traffic as ref_traffic
from bench_h100.trace import profiled

GRAPHS, EPISODES, SAMPLE, WARMUP = 0, 1, 2, 3       # seed streams


def inputs(cell, seed, device) -> SimpleNamespace:
    """The batch, on `device`, and its sizes."""
    g = cell.config["graphs"]
    adj, mask, ns, es = graphs.er_batch(
        runtime.rng(seed, GRAPHS), g["batch"], g["n_lo"], g["n_hi"],
        g["pad_to"], g["mean_degree"])
    return SimpleNamespace(adj=torch.from_numpy(adj).to(device),
                           mask=torch.from_numpy(mask).to(device), ns=ns,
                           es=es)


def forward_flops(cell, inp) -> int:
    m = cell.config["model"]
    dims = gcn.widths(m["feature_size"], m["hidden1"], m["num_layer"])
    return sum(gcn.forward_flops(n, e, dims) for n, e in zip(inp.ns, inp.es))


def program(cell, device):
    """(episode, warm-up episode) closures of the port."""
    from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                              params_from_jax)
    from distgcn_tpu_torch.sim.device_sim import make_closed_loop
    from distgcn_tpu_torch.utils.config import Config
    from distgcn_tpu_torch.utils.serialization import load_params

    m, g, t = cell.config["model"], cell.config["graphs"], cell.traffic
    flags = Config(feature_size=m["feature_size"], hidden1=m["hidden1"],
                   num_layer=m["num_layer"], diver_num=m["diver_num"],
                   max_degree=m["max_degree"], predict=m["predict"],
                   pad_to=g["pad_to"], batch_size=g["batch"],
                   compute_dtype="float32")
    params = params_from_jax(load_params(str(cell.path(
        cell.config["checkpoint"]))))
    model = make_model_from_config(flags, m["family"], params=params,
                                   device=device)

    def loop(timeslots):
        return make_closed_loop(model, flags, timeslots=timeslots,
                                load=t["load"], rate_lo=t["rate_lo"],
                                rate_hi=t["rate_hi"], wt_sel=t["wt_sel"],
                                feature_mode=t["feature_mode"])

    return loop(t["timeslots"]), loop(t["warmup_slots"])


def reference_episode(cell, layers, inp, seed, i, device, mm=None):
    t = cell.traffic
    draws = ref_traffic.Draws(t["load"], t["rate_lo"], t["rate_hi"],
                              device)
    return dense.episode(layers, inp.adj, inp.mask,
                         runtime.generator(device, seed, EPISODES, i),
                         t["timeslots"], draws, t["feature_mode"],
                         t["wt_sel"], mm=mm or (lambda x: x))


def graphs_off(got, want) -> int:
    """Graphs whose final queues or metrics differ in any bit."""
    (q, met), (rq, rmet) = got, want
    bad = (q != rq).any(dim=-1)
    for key, value in rmet.items():
        bad |= met[key] != value
    return int(bad.sum())


def run(cell, seed, seconds, trace, device):
    from bench_h100 import harness

    phases = {"start": harness.process_age_s()}
    runtime.program_setup(device)
    phases["kernels"] = harness.process_age_s()
    inp = inputs(cell, seed, device)
    phases["inputs"] = harness.process_age_s()
    episode, warm = program(cell, device)
    phases["program"] = harness.process_age_s()
    b, n = inp.mask.shape
    q0 = torch.zeros((b, n), device=device)
    warm(inp.adj, inp.mask, q0, runtime.generator(device, seed, WARMUP))
    runtime.sync(device)
    outs = []

    def one():
        i = len(outs)
        outs.append(episode(inp.adj, inp.mask, q0,
                            runtime.generator(device, seed, EPISODES, i)))
        runtime.sync(device)

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
    slots = cell.traffic["timeslots"]
    res = {"e2e": {"setup_s": setup_s,
                   "decisions_per_s": timed * b * slots / window_s},
           "attempted": timed * b, "setup_phases": phases,
           "compile_s": phases["kernels"] - phases["start"],
           "unit_s": runtime.summary(list(np.diff(marks))), "host": host}
    if trace:
        res["trace"] = profiled(cell.traffic["trace_episodes"], one)
        per_episode = slots if cell.traffic["feature_mode"] == "dqn" else 1
        res["work"] = {
            "slots_per_unit": slots,
            "gcn_flops": forward_flops(cell, inp) * per_episode * timed,
            "timed_s": window_s, "timed_units": timed,
            "kernels": {"lgs": {"match": "lgs_kernel",
                                "bound_s": kernels.lgs_bound_s(b, n)}}}
    res.update(runtime.device_facts(device))
    res["power_limit"] = harness.power_limit() if device == "cuda" else None
    del episode, warm
    runtime.free(device)

    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    k = min(cell.traffic["check_episodes"], len(outs))
    pick = sorted(runtime.rng(seed, SAMPLE).choice(len(outs), size=k,
                                                   replace=False))
    off = sum(graphs_off(outs[i], reference_episode(cell, layers, inp, seed,
                                                    i, device))
              for i in pick)
    res["failed"] = off
    res["checks"] = [("graphs_off", off, cell.limits["graphs_off"])]
    return res


def control(cell, seed, device) -> dict:
    """The reference in the program's place at the control precision (one
    step below the stated one), against the reference at the stated one,
    over as many episodes as a run checks."""
    inp = inputs(cell, seed, device)
    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    mm = precision.rounder(cell.config["precision"]["control"])
    off = 0
    for i in range(cell.traffic["check_episodes"]):
        want = reference_episode(cell, layers, inp, seed, i, device)
        got = reference_episode(cell, layers, inp, seed, i, device, mm=mm)
        off += graphs_off(got, want)
    return {"graphs_off": off}
