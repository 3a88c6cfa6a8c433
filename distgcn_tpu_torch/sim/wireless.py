"""Wireless link-scheduling simulator (the host engine).

The port's own copy of `distgcn_tpu/sim/wireless.py`: one engine for the
reference's six wireless scripts (`wireless_dqn_test.py`, `_mc`, `_flood`
and the rollout variants).

- Traffic (wireless_dqn_test.py:179-195): Poisson arrivals via exponential
  interarrivals + cumsum counting; truncated-Gaussian integer link rates in
  [lo, hi]; per-instance seed `treeseed`. The reference seeds numpy's
  global legacy RNG (``np.random.seed(treeseed)``); here one
  ``np.random.RandomState(treeseed)`` is threaded through `gen_arrivals`
  and `gen_link_rates`, which draws the same stream, and nothing touches
  the global RNG.
- Utility selection (wireless_dqn_test.py:219-230): wt_sel in
  {qr, q, qor, qrm, random}; multichannel weights reshaped order='F'. The
  'random' mode draws from a fresh ``RandomState(seed)`` each slot (the
  reference re-seeds the global RNG every slot).
- Queue dynamics (wireless_dqn_test.py:285-293): queue += arrivals;
  schedule; capacity = rates at scheduled (link, channel); departures =
  min(queue, capacity); queue -= departures.
- Algorithms (wireless_dqn_test.py:232-283, _mc:242-356): Greedy (LGS),
  Greedy-Th (dist greedy), Benchmark (exact MWIS — the native B&B of
  `solvers/exact.py` replaces Gurobi), DGCN-LGS, DGCN-LGS-it, DGCN-RS,
  CGCN-CGS, and the sequential multichannel family LGS-Seq / DGCN-LGS-Seq /
  CGCN-RS-Seq.
- Resumable CSV accumulation keyed by (graph, seed, load)
  (wireless_dqn_test.py:172-177, 297-336), written and read with the `csv`
  module in pandas' ``to_csv`` layout, so a sweep that one package began
  resumes under the other.

The conflict graph is static across the slots, so `DGCN-LGS` pins it on the
agent's device once (`agent.prepare`) and streams only the per-slot utility
vector (`solve_mwis_resident`): one LGS launch and one host read a slot.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from distgcn_tpu_torch.solvers import exact as exact_mod
from distgcn_tpu_torch.solvers.greedy import (dist_greedy_search,
                                              local_greedy_search)


@dataclass
class SimParams:
    timeslots: int = 200
    sim_rate_lo: int = 0
    sim_rate_hi: int = 100
    wt_sel: str = "qr"
    n_ch: int = 1
    benchmark: str = "exact"    # 'exact' (native B&B) or 'greedy'
    exact_timeout: float = 10.0


def gen_arrivals(nflows: int, timeslots: int, load: float, rate_lo: int,
                 rate_hi: int, rng: np.random.RandomState) -> np.ndarray:
    """Poisson arrivals [T, nflows] (wireless_dqn_test.py:181-188), drawn
    from `rng` (a legacy `RandomState`, as the reference's global RNG)."""
    arrival_rate = 0.5 * (rate_lo + rate_hi) * load
    inter = rng.exponential(1.0 / arrival_rate,
                            (nflows, int(2 * timeslots * arrival_rate)))
    arrival_time = np.cumsum(inter, axis=1)
    acc = np.zeros((nflows, timeslots))
    for t in range(timeslots):
        acc[:, t] = np.count_nonzero(arrival_time < t, axis=1)
    arrivals = np.diff(acc, prepend=0)
    return arrivals.transpose()


def gen_link_rates(nflows: int, timeslots: int, n_ch: int, rate_lo: int,
                   rate_hi: int, rng: np.random.RandomState) -> np.ndarray:
    """Truncated-Gaussian integer rates [T, nflows, n_ch]
    (wireless_dqn_test.py:190-194), drawn from `rng`."""
    rates = rng.normal(0.5 * (rate_lo + rate_hi), 0.25 * (rate_hi - rate_lo),
                       size=[timeslots, nflows, n_ch])
    rates = rates.astype(int)
    rates[rates < rate_lo] = rate_lo
    rates[rates > rate_hi] = rate_hi
    return rates


def slot_weights(queue_col: np.ndarray, rates_t: np.ndarray, wt_sel: str,
                 seed: Optional[int] = None) -> np.ndarray:
    """Per-slot utilities [nflows, n_ch] (wireless_dqn_test.py:219-230)."""
    q = queue_col[:, None] * np.ones_like(rates_t, dtype=float)
    if wt_sel == "qr":
        return q * rates_t
    if wt_sel == "q":
        return q
    if wt_sel == "qor":
        with np.errstate(divide="ignore", invalid="ignore"):
            w = q / rates_t
        return np.nan_to_num(w, nan=0.0, posinf=0.0)
    if wt_sel == "qrm":
        return np.minimum(q, rates_t)
    return np.random.RandomState(seed).uniform(0, 1, rates_t.shape)


def _benchmark_util(adj, wts, params: SimParams) -> float:
    if params.benchmark == "exact":
        _, val, _ = exact_mod.mwis_exact(adj, wts, params.exact_timeout)
        return val
    _, val = exact_mod.fast_greedy(adj, wts)
    return val


class AlgoRunner:
    """Per-algorithm per-timeslot dispatch (one instance per algo per run)."""

    def __init__(self, name: str, adj_gk: sp.spmatrix, params: SimParams,
                 agent=None, adj_list: Optional[List[sp.spmatrix]] = None,
                 nflows: int = 0):
        self.name = name
        self.adj = sp.csr_matrix(adj_gk)
        self.params = params
        self.agent = agent
        self.adj_list = adj_list or []
        self.nflows = nflows
        self._handle = None
        if agent is not None and name == "DGCN-LGS":
            self._handle = agent.prepare(self.adj)

    def schedule(self, wts1: np.ndarray, queue_mtx_algo: np.ndarray,
                 rates_t: np.ndarray, train: bool = False):
        """Returns (mwis set over (link,channel) product nodes, util_ratio)."""
        p, name = self.params, self.name
        if name == "Greedy":
            mwis, total = local_greedy_search(self.adj, wts1)
            base = _benchmark_util(self.adj, wts1, p)
            return mwis, total / base if base else 1.0
        if name == "Greedy-Th":
            mwis, total = dist_greedy_search(self.adj, wts1, 0.1)
            base = _benchmark_util(self.adj, wts1, p)
            return mwis, total / base if base else 1.0
        if name == "Benchmark":
            solu, _, _ = exact_mod.mwis_exact(self.adj, wts1,
                                              p.exact_timeout)
            return set(solu.tolist()), 1.0
        if name == "DGCN-LGS":
            base = _benchmark_util(self.adj, wts1, p)
            if self._handle is not None:
                mwis, total = self.agent.solve_mwis_resident(self._handle,
                                                             wts1)
            else:
                mwis, total = self.agent.solve_mwis(self.adj, wts1,
                                                    train=train, grd=base)
            return mwis, total / base if base else 1.0
        if name == "DGCN-LGS-it":
            base = _benchmark_util(self.adj, wts1, p)
            mwis, total = self.agent.solve_mwis_dit(self.adj, wts1)
            return mwis, float(total) / base if base else 1.0
        if name == "DGCN-RS":
            base = _benchmark_util(self.adj, wts1, p)
            mwis, total = self.agent.solve_mwis_rollout_wrap(self.adj, wts1)
            return mwis, float(total) / base if base else 1.0
        if name == "CGCN-CGS":
            base = _benchmark_util(self.adj, wts1, p)
            mwis, total = self.agent.solve_mwis_cgs_train(self.adj, wts1,
                                                          train=train,
                                                          grd=base)
            return mwis, float(total) / base if base else 1.0
        if name in ("LGS-Seq", "DGCN-LGS-Seq", "CGCN-RS-Seq"):
            return self._sequential(name, queue_mtx_algo, rates_t), 1.0
        raise ValueError(f"unsupported algorithm {name}")

    def _sequential(self, name: str, queue_mtx_algo: np.ndarray,
                    rates_t: np.ndarray) -> set:
        """Channel-by-channel scheduling with queue-drain estimates
        (wireless_dqn_test_mc.py:292-354). Requires wt_sel='qr'. Updates
        `queue_mtx_algo` in place: column ic+1 holds the drain estimate
        after channel ic."""
        assert self.params.wt_sel == "qr"
        n_ch = self.params.n_ch
        nflows = self.nflows
        mwis: set = set()
        q = queue_mtx_algo
        for ic in range(n_ch):
            wts_ic = q[:, ic] * rates_t[:, ic]
            wts_idx = np.nonzero(wts_ic)[0]
            if wts_idx.size == 0:
                continue
            adj_ii = self.adj_list[ic][wts_idx][:, wts_idx]
            if name == "LGS-Seq":
                mwis_c, _ = local_greedy_search(adj_ii, wts_ic[wts_idx])
            elif name == "DGCN-LGS-Seq":
                mwis_c, _ = self.agent.solve_mwis(adj_ii, wts_ic[wts_idx],
                                                  train=False, grd=100.0)
            else:  # CGCN-RS-Seq
                mwis_c, _ = self.agent.solve_mwis_rollout_wrap(
                    adj_ii, wts_ic[wts_idx])
            sel_links = wts_idx[list(mwis_c)]
            mwis |= set((sel_links + ic * nflows).tolist())
            if ic + 1 < n_ch:
                depart_est = np.minimum(q[:, ic], rates_t[:, ic])
                q[:, ic + 1] = q[:, ic]
                q[sel_links, ic + 1] -= depart_est[sel_links]
        return mwis


def run_instance(adj_gk, nflows: int, load: float, treeseed: int,
                 algolist: Sequence[str], params: SimParams, agent=None,
                 adj_list=None, train: bool = False) -> Dict[str, dict]:
    """Simulate `timeslots` slots for each algorithm on one network instance.

    Returns per-algo metrics: avg/median/95p/5p queue length, mean utility
    ratio (wireless_dqn_test_mc.py:370-387).
    """
    rng = np.random.RandomState(treeseed)
    T, n_ch = params.timeslots, params.n_ch
    arrivals = gen_arrivals(nflows, T, load, params.sim_rate_lo,
                            params.sim_rate_hi, rng)
    rates = gen_link_rates(nflows, T, n_ch, params.sim_rate_lo,
                           params.sim_rate_hi, rng)

    runners = {a: AlgoRunner(a, adj_gk, params, agent, adj_list, nflows)
               for a in algolist}
    queue = {a: np.zeros((T, nflows)) for a in algolist}
    dep = {a: np.zeros((T, nflows)) for a in algolist}
    util = {a: np.zeros(T) for a in algolist}
    for a in algolist:
        util[a][0] = 1.0

    for t in range(1, T):
        for a in algolist:
            queue[a][t] = queue[a][t - 1] + arrivals[t]
            q_algo = queue[a][t][:, None] * np.ones((nflows, n_ch))
            wts0 = slot_weights(queue[a][t], rates[t], params.wt_sel,
                                seed=treeseed * 1000 + t)
            wts1 = np.reshape(wts0, nflows * n_ch, order="F")
            mwis, u = runners[a].schedule(wts1, q_algo, rates[t], train)
            util[a][t] = u
            sched = np.array(sorted(mwis), dtype=int)
            rates_flat = np.reshape(rates[t], nflows * n_ch, order="F")
            capacity = np.zeros(nflows)
            if sched.size:
                links = sched % nflows
                capacity[links] = rates_flat[sched]
            dep[a][t] = np.minimum(queue[a][t], capacity)
            queue[a][t] = queue[a][t] - dep[a][t]

    out = {}
    for a in algolist:
        out[a] = {
            "avg_queue_len": float(np.mean(np.mean(queue[a], axis=1))),
            "med_queue_len": float(np.mean(np.median(queue[a], axis=1))),
            "95p_queue_len": float(np.percentile(queue[a], 95)),
            "5p_queue_len": float(np.percentile(queue[a], 5)),
            "avg_utility": float(np.nanmean(util[a])),
        }
    return out


ALGO_BY_OPT = {0: "DGCN-LGS", 1: "DGCN-LGS-it", 2: "DGCN-RS", 3: "CGCN-CGS",
               4: "DGCN-RS", 5: "DGCN-LGS-Seq", 6: "CGCN-RS-Seq",
               7: "LGS-Seq"}


def algolist_for_opt(opt: int, include_baselines: bool = False) -> List[str]:
    """wireless_dqn_test_mc.py:66-89: opt 0 runs Greedy+DGCN-LGS+Benchmark;
    others run the single named algorithm."""
    name = ALGO_BY_OPT.get(opt)
    if name is None:
        raise ValueError(f"unsupported opt {opt}")
    if opt == 0 or include_baselines:
        return ["Greedy", name, "Benchmark"]
    return [name]


def _cell(value) -> str:
    """A value as pandas' ``to_csv`` writes it (NaN as an empty field)."""
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return "" if np.isnan(value) else repr(float(value))
    return str(value)


def _parse(text: str):
    """A field of a CSV as pandas reads it back: int, float, NaN or str."""
    if text == "":
        return float("nan")
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


class ResumableResults:
    """CSV accumulation with (graph, seed, load) resume keys
    (wireless_dqn_test.py:116-118, 172-177).

    `rows` holds one dict per row, keyed by `COLS`. The file is pandas'
    ``to_csv`` layout: an unnamed index column 0..k-1, then `COLS`.
    """

    COLS = ["graph", "seed", "load", "name", "avg_queue_len", "med_queue_len",
            "95p_queue_len", "5p_queue_len", "avg_utility", "avg_degree"]

    def __init__(self, path: str):
        self.path = path
        self.rows: List[dict] = []
        if os.path.isfile(path):
            with open(path, newline="") as f:
                r = csv.reader(f)
                header = next(r)[1:]
                rows = sorted((int(line[0]), line[1:]) for line in r if line)
            self.rows = [{c: _parse(v) for c, v in zip(header, vals)}
                         for _, vals in rows]

    def done(self, graph, seed, load) -> bool:
        key = round(load, 2)
        return any(row["graph"] == graph and row["seed"] == seed
                   and np.round(row["load"], 2) == key for row in self.rows)

    def append(self, rows: List[dict]) -> None:
        self.rows.extend(rows)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + self.COLS)
            for i, row in enumerate(self.rows):
                w.writerow([i] + [_cell(row.get(c, float("nan")))
                                  for c in self.COLS])
