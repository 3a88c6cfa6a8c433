"""The diver's guided tree search over an evaluation set:
`DiverAgent.solve_mwis_bsf_many(insts, max_pops, batch_pops, group)` on
one lockstep group of `group` instances a call.

Set-up makes the set from the seed (ER conflict graphs, a uniform weight
in [lo, hi) on each link from its own stream), loads the checkpoint into
the port's `DiverAgent` (its search seed drawn from the run's seed) and
runs one warm-up group. The window runs whole groups back to back,
cycling through the set (window group u is the set's group u mod G, G
groups in the set), until ``seconds`` have passed; it ends at a group's
end. ``decisions_per_s`` is the graphs whose search completed in the
window over the window's length: a decision is one graph's schedule,
made by its whole search.

The agent's device calls (`DiverAgent._eval_heads_resident`) are
observed, not changed: each call's batch size (the shared-mode launch's
Q, for `lgs_multi_roofline_pct`) and, for the groups the check may
replay, the states it evaluated and the head probabilities it returned.

The check: on every graph of the window, the exact guarantees
``conflicts`` (graphs whose returned set holds two conflicting links) and
``util_arith_off`` (graphs whose returned utility is not its set's
weight, to 1e-9 relative); on a sample of the window's first G groups,
drawn from the seed (so two versions at different speeds check the same
groups), the plain reference (`reference.diver`) searches the same
instances with the same search seeds and grouping and compares:

- ``graphs_off``: graphs whose returned set or utility differs from the
  reference's;
- ``probs_err``: the largest absolute difference of the head
  probabilities, on each device call whose states equal the reference's
  call of the same step (1.0 where no call could be compared);
- ``completions_off``: states of those calls with a head completion
  (the guided LGS's selection) that differs from the reference's.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp

from bench_h100 import graphs, runtime
from bench_h100.counts import lgs_multi
from bench_h100.reference import checkpoint, diver, precision
from bench_h100.trace import profiled

GRAPHS, WEIGHTS, SAMPLE, AGENT = 0, 1, 2, 3            # seed streams
CHECKS = ("graphs_off", "probs_err", "completions_off", "conflicts",
          "util_arith_off")


def inputs(cell, seed) -> SimpleNamespace:
    """The set on the host: per graph its [n, n] 0/1 numpy adjacency, the
    same as scipy csr (the program's input, as `cli.eval_graphs` gives
    it) and its float32 weights."""
    g = cell.config["graphs"]
    adj, mask, ns, _ = graphs.er_batch(
        runtime.rng(seed, GRAPHS), g["batch"], g["n_lo"], g["n_hi"],
        g["pad_to"], g["mean_degree"])
    w = g["node_weights"]
    rng = runtime.rng(seed, WEIGHTS)
    wts = [(rng.random(n) * (w["hi"] - w["lo"]) + w["lo"]).astype(np.float32)
           for n in ns]
    adjs = [adj[i, :n, :n] for i, n in enumerate(ns)]
    return SimpleNamespace(adjs=adjs, csr=[sp.csr_matrix(a) for a in adjs],
                           wts=wts)


def agent_seed(seed) -> int:
    return runtime.seed_int(seed, AGENT)


def program(cell, seed, device):
    """The port's `DiverAgent`, loaded from the checkpoint."""
    from distgcn_tpu_torch.agents_extra import DiverAgent
    from distgcn_tpu_torch.utils.config import Config

    m, g, s = cell.config["model"], cell.config["graphs"], \
        cell.config["search"]
    flags = Config(feature_size=m["feature_size"], hidden1=m["hidden1"],
                   num_layer=m["num_layer"], diver_num=m["diver_num"],
                   max_degree=m["max_degree"], predict=m["predict"],
                   pad_to=g["pad_to"], backoff_prob=s["backoff_prob"],
                   diver_out=s["diver_out"], compute_dtype="float32")
    agent = DiverAgent(flags, seed=agent_seed(seed), device=device)
    if not agent.load(str(cell.path(cell.config["checkpoint"]).parent)):
        raise RuntimeError("the diver checkpoint did not load")
    return agent


class Observer:
    """Wraps the agent's device call: keeps each call's Q, and while
    `keep` is a list each call's states, probabilities and completions."""

    def __init__(self, agent):
        self.real = agent._eval_heads_resident
        self.qs, self.keep = [], None
        agent._eval_heads_resident = self

    def __call__(self, adjs_dev, gidx, masks, wts_rows, ns):
        out = self.real(adjs_dev, gidx, masks, wts_rows, ns)
        self.qs.append(len(ns))
        if self.keep is not None:
            self.keep.append((np.asarray(gidx), np.asarray(masks), out[1],
                              out[0]))
        return out


def _counters():
    """The program's counters: B1's launches, and the search's device
    calls and states where the program counts them."""
    from distgcn_tpu_torch.agents_extra import DiverAgent
    from distgcn_tpu_torch.ops.lgs_cuda import batched_lgs_kernel
    out = {"lgs_launches": batched_lgs_kernel.launches}
    for name in ("bsf_calls", "bsf_states"):
        value = getattr(DiverAgent, name, None)
        if value is not None:
            out[name] = value
    return out


def guarantees(inp, first: int, results) -> tuple:
    """(conflicts, util_arith_off, graphs failing either) over `results`
    of the set's graphs first, first + 1, ..."""
    conflicts = util_off = bad = 0
    for j, (links, util) in enumerate(results):
        i = first + j
        s = np.array(sorted(links), np.int64)
        c = bool(s.size) and bool(inp.adjs[i][np.ix_(s, s)].any())
        want = float(inp.wts[i].astype(np.float64)[s].sum())
        o = abs(util - want) > 1e-9 * max(abs(want), 1.0)
        conflicts, util_off, bad = conflicts + c, util_off + o, bad + (c or o)
    return conflicts, util_off, bad


def reference_group(cell, layers, inp, seed, g, device, mm=None,
                    calls=None):
    """The reference's search of the set's group g, as a run searches it."""
    t, s, m = cell.traffic, cell.config["search"], cell.config["model"]
    k = t["group"]
    lo = g * k
    return diver.search(
        layers, inp.adjs[lo: lo + k], inp.wts[lo: lo + k], agent_seed(seed),
        t["max_pops"], t["batch_pops"], k, min(m["diver_num"], s["diver_out"]),
        s["backoff_prob"], m["feature_size"], cell.config["graphs"]["pad_to"],
        device, mm=mm or (lambda x: x), calls=calls)


def compare(got, got_calls, want, want_calls) -> dict:
    """graphs_off, probs_err and completions_off of one group: `got_calls`
    and `want_calls` hold (gidx, masks, probs, sel) of each device call,
    probs [n, D] and sel [D, n] per state or padded."""
    off = sum(gs != ws or gu != wu for (gs, gu), (ws, wu) in zip(got, want))
    err, compared, sel_off = 0.0, 0, 0
    for (gidx, masks, probs, sel), (wgidx, wmasks, wprobs, wsel) in zip(
            got_calls, want_calls):
        if not (np.array_equal(gidx, wgidx)
                and np.array_equal(masks, wmasks)):
            break                                  # the searches diverged
        for i, (p, s) in enumerate(zip(probs, sel)):
            n = p.shape[0]
            err = max(err, float(np.abs(p - wprobs[i, :n]).max()))
            sel_off += not np.array_equal(s[:, :n], wsel[i, :, :n])
        compared += 1
    return {"graphs_off": int(off), "probs_err": err if compared else 1.0,
            "completions_off": sel_off}


def _fold(into: dict, got: dict) -> None:
    """Counts add up over groups; probs_err takes the largest."""
    for key, value in got.items():
        into[key] = (max(into[key], value) if key == "probs_err"
                     else into[key] + value)


def picked(cell, seed, n_groups: int) -> list:
    """The set's groups a run checks, drawn from the seed."""
    k = min(cell.traffic["check_groups"], n_groups)
    return sorted(int(i) for i in runtime.rng(seed, SAMPLE).choice(
        n_groups, size=k, replace=False))


def run(cell, seed, seconds, trace, device):
    from bench_h100 import harness

    t = cell.traffic
    phases = {"start": harness.process_age_s()}
    runtime.program_setup(device)
    phases["kernels"] = harness.process_age_s()
    inp = inputs(cell, seed)
    insts = list(zip(inp.csr, inp.wts))
    phases["inputs"] = harness.process_age_s()
    agent = program(cell, seed, device)
    obs = Observer(agent)
    phases["program"] = harness.process_age_s()
    k = t["group"]
    n_groups = len(insts) // k
    pick = picked(cell, seed, n_groups)
    keep = set(pick) | {0}
    results, kept, unit_qs = [], {}, []

    def group(g):
        return agent.solve_mwis_bsf_many(
            insts[g * k: (g + 1) * k], max_pops=t["max_pops"],
            batch_pops=t["batch_pops"], group=k)

    for _ in range(t["warmup_groups"]):
        group(0)
    runtime.sync(device)

    def one():
        u, first = len(results), len(obs.qs)
        obs.keep = [] if u in keep else None
        results.append(group(u % n_groups))
        runtime.sync(device)
        if obs.keep is not None:
            kept[u] = obs.keep
        obs.keep = None
        unit_qs.append(obs.qs[first:])

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
    timed = len(results)
    res = {"e2e": {"setup_s": setup_s,
                   "decisions_per_s": timed * k / window_s},
           "attempted": timed * k, "setup_phases": phases,
           "compile_s": phases["kernels"] - phases["start"],
           "unit_s": runtime.summary(list(np.diff(marks))), "host": host}
    if trace:
        n = t["trace_groups"]
        res["trace"] = profiled(n, one,
                                _counters if device == "cuda" else None)
        qs = [q for unit in unit_qs[-n:] for q in unit]
        res["work"] = {"timed_s": window_s, "timed_units": timed,
                       "kernels": {"lgs_multi": {
                           "match": "lgs_kernel",
                           "bound_s": lgs_multi.bound_s(
                               qs, cell.config["model"]["diver_num"],
                               cell.config["graphs"]["pad_to"])}}}
    res.update(runtime.device_facts(device))
    res["power_limit"] = harness.power_limit() if device == "cuda" else None
    del agent, obs
    runtime.free(device)

    conflicts = util_off = bad = 0
    for u, out in enumerate(results[:timed]):
        c, o, b = guarantees(inp, (u % n_groups) * k, out)
        conflicts, util_off, bad = conflicts + c, util_off + o, bad + b
    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    worst = {"graphs_off": 0, "probs_err": 0.0, "completions_off": 0}
    for u in [u for u in pick if u < timed] or [0]:
        calls = []
        want = reference_group(cell, layers, inp, seed, u % n_groups,
                               device, calls=calls)
        _fold(worst, compare(results[u], kept[u], want, calls))
    worst.update(conflicts=conflicts, util_arith_off=util_off)
    res["failed"] = bad
    res["checks"] = [(name, worst[name], cell.limits[name])
                     for name in CHECKS]
    return res


def control(cell, seed, device) -> dict:
    """The reference one precision step below the stated one (TF32
    operands) in the program's place, against the reference at the stated
    one, on the groups a run checks."""
    inp = inputs(cell, seed)
    layers = checkpoint.load_layers(cell.path(cell.config["checkpoint"]),
                                    device)
    low = precision.rounder(cell.config["precision"]["control"])
    out = dict.fromkeys(CHECKS, 0)
    for g in picked(cell, seed, len(inp.adjs) // cell.traffic["group"]):
        got_calls, want_calls = [], []
        got = reference_group(cell, layers, inp, seed, g, device, mm=low,
                              calls=got_calls)
        want = reference_group(cell, layers, inp, seed, g, device,
                               calls=want_calls)
        conflicts, util_off, _ = guarantees(inp, g * cell.traffic["group"],
                                            got)
        _fold(out, dict(compare(got, got_calls, want, want_calls),
                        conflicts=conflicts, util_arith_off=util_off))
    return out
