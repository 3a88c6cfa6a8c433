"""The diver's best-solution-first tree search, plainly: GCN_DEEP_DIVER
(Li, Chen & Koltun, "Combinatorial Optimization with Graph Convolutional
Networks and Guided Tree Search", NeurIPS 2018; the upstream's
gcn/models.py:301-438) guiding local greedy completions, searched
best-solution-first (mwis_dqn_test.py:59-135).

The forward of a batch of partial states: each state's graph is its
instance's graph restricted to its remaining links (rows and columns of
the others zeroed); supports [I, L], L = I - D^-1/2 A D^-1/2
(`dense.supports`); features 1/F on the remaining links; layers
out = x @ W0 + L @ (x @ W1), ReLU on every layer but the last, no bias;
the head's 2*D columns are D two-class heads at interleaved column pairs,
and a head's in-set probability is its softmax's class 1 (the odd
column). Head k guides one LGS completion (`lgs.lgs_dense`) of the
state's remaining links on probability x weight. `mm` rounds the operands
of every matrix product (the stated precision: none; the control: TF32);
the forward runs in full float32 whatever the process's TF32 flags say.

The search of one instance: open partial labelings (-1 remaining, 0 out,
1 in), taken least (-utility of the completion that pushed it, push
counter) first, the root first; pops are taken `batch_pops` at a time while
fewer than `max_pops` were taken; a popped state with no remaining link
settles as a candidate. For each evaluated state the first `noout` heads
in order of their largest probability (numpy's argsort of its negation)
each offer their completion, fixed links included, as a candidate (kept
if strictly better); then, for a head whose completion is not empty, one
uniform draw from the instance's numpy generator, seeded (agent seed,
index of the instance in the call), decides with probability `backoff` to
push two children of the state: the head's chosen link of highest
probability (the first of equal ones) fixed in with its remaining
neighbours out ("deepen"), and that link out ("backoff"); a child is
pushed only if no equal labeling was pushed before. Utilities are float64
sums of the float32 weights.

Lockstep: the instances of a call are searched together, at most `group`
at a time in index order; each step pops a batch from every unfinished
instance in that order and evaluates all popped states in one batched
forward, so the matrix products have the shapes of the program's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench_h100.reference import dense, lgs, precision


def forward(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor,
            sup: torch.Tensor, mm: Callable = lambda t: t) -> torch.Tensor:
    """x [Q, N, F], supports [Q, 2, N, N] -> the head's [Q, N, 2 * D]."""
    lap = sup[:, 1]
    last = len(layers) - 1
    for i, p in enumerate(layers):
        out = torch.matmul(mm(x), mm(p["w_0"]))
        out = out + torch.matmul(mm(lap), mm(torch.matmul(mm(x),
                                                          mm(p["w_1"]))))
        x = torch.relu(out) if i < last else out
    return x


@precision.in_full_f32
def evaluate(layers, adj: torch.Tensor, gidx: torch.Tensor,
             masks: torch.Tensor, wts: torch.Tensor, feature_size: int,
             mm: Callable = lambda t: t, chunk: int = 16):
    """Q states at once: adj [G, N, N] 0/1 (the call's instances), gidx [Q]
    int64 (each state's instance), masks [Q, N] float32 (its remaining
    links), wts [Q, N] float32 (its weights on them) -> (sel [Q, D, N]
    int8 of each head's completion, probs [Q, N, D] float32). The
    completions run `chunk` states at a time."""
    m = masks
    bmask = m > 0
    madj = adj[gidx].to(torch.float32) * (m[:, :, None] * m[:, None, :])
    x = torch.full(m.shape + (feature_size,), 1.0 / feature_size,
                   dtype=torch.float32, device=m.device) * m[..., None]
    out = forward(layers, x, dense.supports(madj, bmask), mm) * m[..., None]
    q, n = m.shape
    d = out.shape[-1] // 2
    probs = torch.softmax(out.reshape(q, n, d, 2), dim=-1)[..., 1] \
        * m[..., None]
    guided = probs.transpose(1, 2) * wts[:, None, :]           # [Q, D, N]
    adjb = madj > 0
    sel = torch.empty((q, d, n), dtype=torch.int8, device=m.device)
    for a in range(0, q, chunk):
        b = min(a + chunk, q)
        rows = adjb[a:b].repeat_interleave(d, dim=0)
        sel[a:b] = lgs.lgs_dense(
            rows, guided[a:b].reshape(-1, n),
            bmask[a:b].repeat_interleave(d, dim=0)).reshape(b - a, d, n)
    return sel, probs


class Search:
    """One instance's search: `adj` [n, n] numpy 0/1, `wts` [n] float32."""

    def __init__(self, adj: np.ndarray, wts: np.ndarray, max_pops: int,
                 batch_pops: int, noout: int, backoff: float,
                 rng: np.random.Generator):
        self.adj = adj
        self.wts = np.asarray(wts, np.float32).astype(np.float64)
        self.max_pops, self.batch_pops = max_pops, batch_pops
        self.noout, self.backoff, self.rng = noout, backoff, rng
        root = np.full(self.wts.size, -1, np.int8)
        self.open = [(-np.inf, 0, root.tobytes())]
        self.seen = {root.tobytes()}
        self.pushed = 1
        self.pops = 0
        self.best_set, self.best_util = set(), -np.inf

    @property
    def done(self) -> bool:
        return not self.open or self.pops >= self.max_pops

    def _offer(self, links, util):
        if util > self.best_util:
            self.best_util, self.best_set = util, set(links)

    def _push(self, labels: np.ndarray, util: float):
        key = labels.tobytes()
        if key not in self.seen:
            self.seen.add(key)
            self.open.append((-util, self.pushed, key))
            self.pushed += 1

    def pop(self) -> list:
        """The next batch of states to evaluate: (labels, fixed links,
        their utility) each."""
        batch = []
        while self.open and len(batch) < self.batch_pops \
                and self.pops < self.max_pops:
            first = min(range(len(self.open)), key=self.open.__getitem__)
            labels = np.frombuffer(self.open.pop(first)[2], np.int8).copy()
            self.pops += 1
            fixed = np.nonzero(labels == 1)[0]
            util = float(self.wts[fixed].sum())
            if not (labels == -1).any():
                self._offer(fixed.tolist(), util)
                continue
            batch.append((labels, fixed, util))
        return batch

    def absorb(self, batch, sels, probs):
        """sels [D, n] int8 and probs [n, D] of each state of `batch`."""
        for (labels, fixed, fixed_util), sel, p in zip(batch, sels, probs):
            for k in np.argsort(-p.max(axis=0))[: self.noout]:
                chosen = np.nonzero(sel[k] == 1)[0]
                if chosen.size == 0:
                    continue
                util = fixed_util + float(self.wts[chosen].sum())
                self._offer(fixed.tolist() + chosen.tolist(), util)
                if self.rng.random() >= self.backoff:
                    continue
                v = int(chosen[np.argmax(p[chosen, k])])
                deepen = labels.copy()
                deepen[v] = 1
                nbrs = np.nonzero(self.adj[v])[0]
                deepen[nbrs[deepen[nbrs] == -1]] = 0
                self._push(deepen, util)
                out = labels.copy()
                out[v] = 0
                self._push(out, util)

    def result(self):
        if self.best_util == -np.inf:
            return set(), 0.0
        return self.best_set, float(self.best_util)


def search(layers, adjs: List[np.ndarray], wts: List[np.ndarray],
           seed: int, max_pops: int, batch_pops: int, group: int,
           noout: int, backoff: float, feature_size: int, pad_to: int,
           device, mm: Callable = lambda t: t,
           calls: Optional[list] = None) -> list:
    """The lockstep search of one call's instances (adjacency [n, n] numpy
    0/1 and float32 weights each) -> [(set, utility)] in their order.
    Each evaluation's (gidx, masks, probs, sel) is appended to `calls` if
    given, gidx holding each state's instance's place among the unfinished
    ones (the program's resident row)."""
    n_pad = max(pad_to, -(-max(w.size for w in wts) // pad_to) * pad_to)
    dense_adj = np.zeros((len(adjs), n_pad, n_pad), np.float32)
    wrows = np.zeros((len(adjs), n_pad), np.float32)
    for i, (a, w) in enumerate(zip(adjs, wts)):
        dense_adj[i, : w.size, : w.size] = a
        wrows[i, : w.size] = w
    adj_dev = torch.from_numpy(dense_adj).to(device)
    results = [None] * len(adjs)
    todo, active = list(range(len(adjs))), []
    while todo or active:
        while todo and len(active) < group:
            i = todo.pop(0)
            active.append((i, Search(adjs[i], wts[i], max_pops, batch_pops,
                                     noout, backoff,
                                     np.random.default_rng((seed, i)))))
        batches = [s.pop() for _, s in active]
        inst, gidx, masks = [], [], []
        for pos, ((i, s), batch) in enumerate(zip(active, batches)):
            for labels, _, _ in batch:
                m = np.zeros(n_pad, np.float32)
                m[: labels.size] = labels == -1
                inst.append(i)
                gidx.append(pos)
                masks.append(m)
        if masks:
            g = torch.tensor(inst, dtype=torch.int64, device=device)
            mk = torch.from_numpy(np.stack(masks)).to(device)
            w = mk * torch.from_numpy(wrows).to(device)[g]
            sel, probs = evaluate(layers, adj_dev, g, mk, w, feature_size,
                                  mm)
            sel, probs = sel.cpu().numpy(), probs.cpu().numpy()
            if calls is not None:
                calls.append((np.asarray(gidx), np.stack(masks), probs,
                              sel))
            o = 0
            for (i, s), batch in zip(active, batches):
                n = s.wts.size
                s.absorb(batch, sel[o: o + len(batch), :, :n],
                         probs[o: o + len(batch), :n])
                o += len(batch)
        still = []
        for i, s in active:
            if s.done:
                results[i] = s.result()
            else:
                still.append((i, s))
        active = still
    return results
