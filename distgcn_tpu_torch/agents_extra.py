"""Additional agent families: legacy DQN, MLP ablation, diver tree search.

Port of `distgcn_tpu/agents_extra.py`.

- `LegacyDQNAgent`: the flag-driven DQN of `mwis_dqn_call.py` (model family
  gcn_dqn): feature mode "dqn" (:129-138); epsilon randomizes the *score
  vector* during training (:226-228); replay assigns target_f[solution] =
  reward without batch standardization and keeps its memory (:151-186).
- `MLPAgent`: the topology-blind ablation of `mwis_mlp_call.py`, an `MLP2`
  Q-net over per-node degree features (:70-81).
- `DiverAgent`: a `GCNDeepDiver` emits diver_num score heads; the
  best-solution-first tree search (`solve_mwis_bsf`, and
  `solve_mwis_bsf_many` for several instances in lockstep, both through
  one loop, `_bsf_lockstep`) pops partial states from a host heap
  (`_BsfSearch`, the JAX package's search, its per-head loop done in
  whole-array passes) and evaluates each pop batch on the device in one
  call: masked supports, the GCN, the per-head softmax, the guided
  weights and all Q x D guided LGS completions through
  `ops.lgs.batched_lgs_multi` (one kernel launch with ``share = D`` on a
  card). Host-side draws use the JAX package's numpy seeds, so both
  packages search alike. The searches carry the program spans of
  `utils.profiling.span`: ``distgcn.episode`` (a search call),
  ``distgcn.slot`` (one lockstep step: pops, the device call, absorb),
  ``distgcn.gcn`` (masking, state arrays, forward, head softmax, guided
  weights), ``distgcn.lgs`` (the completions' launch and the read-back)
  and ``distgcn.sync`` (each of the two reads to the host).
"""

from __future__ import annotations

import heapq
import os
import time
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.agents import DQNAgent, MWISSolver, build_state_arrays
from distgcn_tpu_torch.core.graph import (GraphBatch, graph_fingerprint,
                                          pad_bucket)
from distgcn_tpu_torch.models.gcn import cast_model
from distgcn_tpu_torch.ops.lgs import batched_lgs_multi
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.profiling import span


class LegacyDQNAgent(DQNAgent):
    """mwis_dqn_call.py DQNAgent semantics."""

    def __init__(self, flags: Config, memory_size: int = 5000, seed: int = 0,
                 device=None):
        super().__init__(flags, memory_size, model_family="gcn_dqn",
                         seed=seed, device=device)
        self.feature_mode = "dqn"      # wts/||wts|| features (row-normalized)
        self.trainer.style = "dqn"     # assignment targets, no standardization

    def act(self, state, train: bool = False):
        act_values, action = self.predict(state)
        if train and self._rng.random() <= self.epsilon:
            # legacy DQN randomizes the score vector itself
            # (mwis_dqn_call.py:226-228)
            act_values = self._rng.uniform(size=act_values.shape)
        return act_values, action

    def replay(self, batch_size: int):
        """mwis_dqn_call.py:151-186: no target net sync, memory retained."""
        if len(self.memory) < batch_size:
            return None
        minibatch = self._replay_rng.sample(list(self.memory), batch_size)
        loss = self.trainer.train_minibatch(minibatch)
        if self.epsilon > self.epsilon_min:
            self.epsilon *= self.epsilon_decay
        return loss


class MLPAgent(DQNAgent):
    """mwis_mlp_call.py: MLP2 Q-net over degree features (graph-blind)."""

    def __init__(self, flags: Config, memory_size: int = 5000, seed: int = 0,
                 device=None):
        super().__init__(flags, memory_size, model_family="mlp2", seed=seed,
                         device=device)

    def makestate(self, adj, wts_nn) -> dict:
        adj = sp.csr_matrix(adj)
        n = adj.shape[0]
        deg = np.asarray((adj != 0).sum(axis=1)).flatten().astype(np.float32)
        feats = np.repeat(deg[:, None], self.flags.feature_size, axis=1)
        feats = feats / (feats.max() + 1e-9)
        bucket = max(self.flags.pad_to,
                     -(-n // self.flags.pad_to) * self.flags.pad_to)
        padded = np.zeros((1, bucket, self.flags.feature_size), np.float32)
        padded[0, :n] = feats
        gb = GraphBatch.single(adj, np.asarray(wts_nn).flatten(),
                               pad_to=bucket, device=self.device)
        return {"graph": gb,
                "features": torch.from_numpy(padded).to(self.device),
                "supports": None,
                "wts": np.asarray(wts_nn, dtype=np.float32).flatten(),
                "adj": adj}

    @torch.no_grad()
    def predict(self, state):
        gb: GraphBatch = state["graph"]
        out = self.model(state["features"])
        out = out * gb.mask[..., None].to(out.dtype)
        n = state["adj"].shape[0]
        act_values = out[0, :n, :].cpu().numpy()
        return act_values, np.argmax(act_values, axis=0)


def exact_sums(w) -> bool:
    """Whether every sum of a subset of the weights `w` is the same float64
    in every order of summation: each weight a float32 value, none -0.0,
    and sum |w| < 2^(53 + e), e = floor(log2(min nonzero |w|)) - 23. Each
    weight is then a whole multiple of 2^e, so every partial sum is one of
    fewer than 2^53 of them, exactly."""
    w = np.asarray(w, np.float64)
    with np.errstate(over="ignore"):
        if not np.array_equal(w, w.astype(np.float32)):
            return False
    if np.signbit(w[w == 0]).any():
        return False
    a = np.abs(w[w != 0])
    if not a.size:
        return True
    e = int(np.frexp(a.min())[1]) - 24
    return bool(a.sum() < np.ldexp(1.0, 53 + e))


class _BsfSearch:
    """Per-graph state of the best-solution-first tree search, so that
    independent instances' searches can run in lockstep and share device
    calls (`DiverAgent.solve_mwis_bsf_many`). A heap of partial labelings
    nIS_vec in {-1 remain, 0 excluded, 1 fixed} ordered best-solution-first;
    deepen/backoff children per head with probability `backoff`
    (mwis_dqn_test.py:59-135 machinery; flags runtime_config.py:19-20).
    The JAX package's search: the same candidates, heap tuples and draws in
    the same order."""

    def __init__(self, adj_0, wts_0, max_pops, batch_pops, noout, backoff,
                 rng):
        self.adj = sp.csr_matrix(adj_0)
        self.wts = np.asarray(wts_0, dtype=np.float64).flatten()
        self.max_pops = max_pops
        self.batch_pops = batch_pops
        self.noout = noout
        self.backoff = backoff
        self.rng = rng
        root = -np.ones(self.wts.size, dtype=np.int8)
        self.heap = [(-np.inf, 0, root.tobytes())]
        self.seen = {root.tobytes()}
        self.counter = 1
        self.best_set, self.best_util = set(), -np.inf
        self.pops = 0
        self.exact = exact_sums(self.wts)

    @property
    def done(self) -> bool:
        return not self.heap or self.pops >= self.max_pops

    def pop_batch(self):
        """Pop up to batch_pops best-first states; complete states settle
        immediately. Returns [(nis, rem_idx, fixed_idx, fixed_util)]."""
        batch = []
        while (self.heap and len(batch) < self.batch_pops
               and self.pops < self.max_pops):
            _, _, blob = heapq.heappop(self.heap)
            nis = np.frombuffer(blob, dtype=np.int8).copy()
            self.pops += 1
            remain = nis == -1
            fixed_idx = np.nonzero(nis == 1)[0]
            fixed_util = float(self.wts[fixed_idx].sum())
            if not remain.any():
                if fixed_util > self.best_util:
                    self.best_util = fixed_util
                    self.best_set = set(fixed_idx.tolist())
                continue
            batch.append((nis, np.nonzero(remain)[0], fixed_idx,
                          fixed_util))
        return batch

    def absorb(self, batch, sels, probs_l):
        """Fold the device evaluation of `batch`'s states back in: record
        head completions as candidates, push deepen/backoff children.
        sels [D, n] / probs [n, D] of each state index global node ids
        (rows of excluded nodes carry sel 0 / probs 0).

        The JAX package's per-head loop, computed by whole-array passes
        over the batch's states and heads: the same candidates, draws and
        pushes. Children are built only while the search will pop again:
        once `pops` reaches `max_pops` the heap is never read. A head's
        utility is one float64 product where every order of summation
        gives the same sum (`exact_sums`), else numpy's sum of the chosen
        weights, head by head, as the loop sums them."""
        if not batch:
            return
        if not self.exact:
            DiverAgent.bsf_fallback_states += len(batch)
        sel = np.stack(sels) == 1                              # [q, D, n]
        probs = np.stack(probs_l)                              # [q, n, D]
        order = np.argsort(-probs.max(axis=1), axis=-1)[:, : self.noout]
        nonempty = sel.any(axis=-1)[np.arange(len(batch))[:, None], order]
        # the nonempty ordered heads, state by state in head order
        flat = np.flatnonzero(nonempty)
        if not flat.size:
            return
        st = flat // order.shape[1]
        hd = order.ravel()[flat]
        if self.exact:
            sums = (sel.astype(np.float64) @ self.wts)[st, hd]
        else:
            sums = np.array([self.wts[sel[s, k]].sum()
                             for s, k in zip(st.tolist(), hd.tolist())])
        util = np.array([b[3] for b in batch])[st] + sums
        top = int(np.argmax(util))                  # the first of the best
        if util[top] > self.best_util:
            self.best_util = float(util[top])
            self.best_set = set(batch[st[top]][2].tolist()) | set(
                np.flatnonzero(sel[st[top], hd[top]]).tolist())
        hit = np.flatnonzero(self.rng.random(flat.size) < self.backoff)
        if self.pops >= self.max_pops or not hit.size:
            return
        st, hd = st[hit], hd[hit]
        # branch on each head's highest-scored selected node (the first)
        v = np.argmax(np.where(sel[st, hd], probs[st, :, hd], -np.inf),
                      axis=1)
        backoff = np.stack([b[0] for b in batch])[st]        # [P, n] int8
        ar = np.arange(st.size)
        deepen = backoff.copy()
        deepen[ar, v] = 1
        # deepen: v's remaining neighbours (its CSR row) excluded
        lo = self.adj.indptr[v]
        cnt = self.adj.indptr[v + 1] - lo
        r = np.repeat(ar, cnt)
        c = self.adj.indices[np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
                             + np.arange(cnt.sum())]
        free = deepen[r, c] == -1
        deepen[r[free], c[free]] = 0
        backoff[ar, v] = 0
        blob = np.stack([deepen, backoff], axis=1).tobytes()
        n = backoff.shape[1]
        keys = util[hit].tolist()
        pushed = self.counter
        for i in range(2 * st.size):                # deepen, then backoff
            b = blob[i * n: (i + 1) * n]
            if b not in self.seen:
                self.seen.add(b)
                heapq.heappush(self.heap, (-keys[i // 2], self.counter, b))
                self.counter += 1
        DiverAgent.bsf_children += self.counter - pushed

    def result(self):
        if self.best_util == -np.inf:
            return set(), 0.0
        return self.best_set, float(self.best_util)


class DiverAgent(MWISSolver):
    """Diverse-head tree-search agent (re-spec of mwis_rollout_call).

    ``DiverAgent.bsf_calls`` counts the search's device calls
    (`_bsf_eval`) and ``DiverAgent.bsf_states`` the states they evaluated,
    ``bsf_fallback_states`` those of them whose heads' utilities were
    summed head by head (weights that fail `exact_sums`) and
    ``bsf_children`` the children pushed,
    over every agent of the process."""

    bsf_calls = 0
    bsf_states = 0
    bsf_fallback_states = 0
    bsf_children = 0

    def __init__(self, flags: Config, memory_size: int = 5000, seed: int = 0,
                 device=None):
        # the deep_diver model emits 2*diver_num logits (diver_num 2-class
        # heads)
        super().__init__(flags, memory_size, model_family="deep_diver",
                         seed=seed, device=device)

    @torch.no_grad()
    def head_scores(self, state) -> np.ndarray:
        """Per-head node scores: softmax over each head's 2 logits, the
        'in-IS' class probability (head k at the interleaved column pair
        (2k, 2k+1), class 1 at the odd column). Returns [N, diver_num]."""
        gb = state["graph"]
        out = self.model(state["features"], state["supports"])
        out = out * gb.mask[..., None].to(out.dtype)
        n = state["adj"].shape[0]
        logits = out[0, :n, :].cpu().numpy()              # [N, 2*diver]
        d = self.flags.diver_num
        heads = logits[:, : 2 * d].reshape(n, d, 2)
        neg, pos = heads[..., 0], heads[..., 1]
        z = np.exp(pos - np.maximum(pos, neg))
        zn = np.exp(neg - np.maximum(pos, neg))
        return z / (z + zn)

    def _resident_adjs(self, adjs, bucket) -> torch.Tensor:
        """A group's dense padded int8 adjacencies [G, Np, Np] on the
        device, uploaded once per group; per pop batch only [Q, Np] masks
        and weights travel. Single-graph groups are cached by content (16
        entries: the wireless root pop presents the same conflict graph
        every slot)."""
        cache = None
        if len(adjs) == 1:
            cache = getattr(self, "_bsf_adj_cache", None)
            if cache is None:
                cache = self._bsf_adj_cache = {}
            key = (graph_fingerprint(adjs[0]), bucket)
            dev = cache.get(key)
            if dev is not None:
                return dev
            if len(cache) >= 16:
                cache.pop(next(iter(cache)))
        dense = np.zeros((len(adjs), bucket, bucket), np.int8)
        for i, a in enumerate(adjs):
            a = sp.csr_matrix(a)
            n = a.shape[0]
            dense[i, :n, :n] = a.toarray() != 0
        dev = torch.from_numpy(dense).to(self.device)
        if cache is not None:
            cache[key] = dev
        return dev

    def _eval_heads_resident(self, adjs_dev, gidx, masks, wts_rows, ns):
        """Q states -> one device call: masked supports, GCN head scores
        and all Q x diver_num guided LGS completions. gidx maps each state
        to its graph's row of `adjs_dev`; masks / wts_rows are [Q, Np] host
        arrays (remain-mask and masked weights). Returns (sels: list of
        [D, n] int8, probs: list of [n, D]) in global node ids."""
        dev = self.device
        sel, probs = self._bsf_eval(
            adjs_dev, torch.from_numpy(np.asarray(gidx, np.int64)).to(dev),
            torch.from_numpy(np.asarray(wts_rows, np.float32)).to(dev),
            torch.from_numpy(np.asarray(masks, np.float32)).to(dev))
        with span("distgcn.lgs"):
            with span("distgcn.sync"):
                sel = sel.cpu().numpy()                       # [Q, D, Np]
            with span("distgcn.sync"):
                probs = probs.cpu().numpy()                   # [Q, Np, D]
        return ([sel[i, :, : ns[i]] for i in range(len(ns))],
                [probs[i, : ns[i]] for i in range(len(ns))])

    @torch.no_grad()
    def _bsf_eval(self, adjs, gidx, wts, mask):
        """Mask the resident adjacencies, GCN forward, per-head in-IS
        softmax, head-guided weights, and all Q x diver_num LGS completions
        through `batched_lgs_multi` (one adjacency per state shared by all
        diver heads). bf16 scoring (``compute_dtype``) casts features,
        supports and params; the guided weights and probs stay f32, so
        tie-breaks are computed on f32 values."""
        flags = self.flags
        d = flags.diver_num
        qn, npad = wts.shape
        DiverAgent.bsf_calls += 1
        DiverAgent.bsf_states += qn
        with span("distgcn.gcn"):
            bmask = mask > 0
            madj = adjs[gidx] * (bmask[:, :, None] & bmask[:, None, :]).to(
                adjs.dtype)
            feats, sups = build_state_arrays(
                madj, wts, bmask, flags.feature_size, flags.max_degree,
                flags.predict, self.feature_mode)
            net = self.model
            if flags.compute_dtype == "bfloat16":
                feats, sups = feats.bfloat16(), sups.bfloat16()
                net = cast_model(net, torch.bfloat16)
            out = net(feats, sups).float() * mask[..., None]  # [Q, Np, 2D]
            heads = out[..., : 2 * d].reshape(qn, npad, d, 2)
            probs = torch.softmax(heads, dim=-1)[..., 1] * mask[..., None]
            guided = probs.transpose(1, 2) * wts[:, None, :]  # [Q, D, Np]
        with span("distgcn.lgs"):
            sel = batched_lgs_multi(madj, guided.contiguous(), bmask)[0]
        return sel, probs

    def solve_mwis_bsf(self, adj_0, wts_0, max_pops: int = 16,
                       time_limit: float = None,
                       batch_pops: int = 4) -> Tuple[set, float]:
        """Best-solution-first tree search over partial states (re-spec of
        the missing `mwis_rollout_call.solve_mwis_iterative`).

        A priority queue holds partial labelings nIS_vec in {-1 remain,
        0 excluded, 1 fixed}, ordered best-solution-first by the utility of
        the completion that spawned them. Pops are taken `batch_pops` at a
        time and all diver heads of all of them are evaluated in one device
        call on the masked graph; each of the first `diver_out` heads
        contributes its completion as a candidate and, with probability
        `backoff_prob`, two children: a DEEPEN child fixing the head's
        highest-scored selected node and a BACKOFF child excluding it.
        The search draws from the agent's own generator; it runs through
        the lockstep loop as a group of one.
        """
        with span("distgcn.episode"):
            return self._bsf_lockstep([(adj_0, wts_0)], lambda i: self._rng,
                                      max_pops, time_limit, batch_pops, 1)[0]

    def solve_mwis_bsf_many(self, insts, max_pops: int = 16,
                            time_limit: float = None,
                            batch_pops: int = 4, group: int = 4):
        """Run `group` instances' bsf searches in lockstep: each iteration
        pops up to `batch_pops` states from every active search and
        evaluates all of them in one device call. Per-graph semantics are
        those of `solve_mwis_bsf`; each instance has its own backoff RNG
        seeded (agent seed, instance index), so its result does not depend
        on the group size. The resident graph axis is padded to the
        constant `group`. insts: list of (adj, wts); returns a list of
        (set, util) in input order."""
        with span("distgcn.episode"):
            return self._bsf_lockstep(
                insts, lambda i: np.random.default_rng((self._seed, i)),
                max_pops, time_limit, batch_pops, group)

    def _bsf_lockstep(self, insts, rng, max_pops, time_limit, batch_pops,
                      group):
        """The search loop of both entries: up to `group` searches at a
        time, instance i's joining with backoff generator ``rng(i)`` when
        a place frees. A step pops, evaluates and absorbs every active
        search; the deadline is checked before each step, and on it every
        active search returns its best so far (instances not yet joined
        return None)."""
        noout = min(self.flags.diver_num, self.flags.diver_out)
        backoff = self.flags.backoff_prob
        deadline = (time.time() + time_limit) if time_limit else None
        results = [None] * len(insts)
        todo = list(range(len(insts)))
        bucket = pad_bucket(max(np.asarray(w).size for _, w in insts),
                            self.flags.pad_to)
        active = []                                     # (idx, _BsfSearch)
        adjs_dev = None                       # rebuilt on active-set change
        nactive = -1
        while todo or active:
            with span("distgcn.slot"):
                joined = False
                while todo and len(active) < group:
                    i = todo.pop(0)
                    active.append((i, _BsfSearch(
                        insts[i][0], insts[i][1], max_pops, batch_pops,
                        noout, backoff, rng(i))))
                    joined = True
                if deadline and time.time() > deadline:
                    break
                if joined or adjs_dev is None or nactive != len(active):
                    pads = [sp.csr_matrix((1, 1), dtype=np.float32)
                            ] * (group - len(active))
                    adjs_dev = self._resident_adjs(
                        [s.adj for _, s in active] + pads, bucket)
                    nactive = len(active)
                    wrows = np.zeros((group, bucket), np.float32)
                    for gi, (_, s) in enumerate(active):
                        wrows[gi, : s.wts.size] = s.wts
                batches = []
                gidx, masks, wl, ns = [], [], [], []
                for gi, (_, s) in enumerate(active):
                    b = s.pop_batch()
                    batches.append(b)
                    for _, ri, _, _ in b:
                        m = np.zeros(bucket, np.float32)
                        m[ri] = 1.0
                        gidx.append(gi)
                        masks.append(m)
                        wl.append(m * wrows[gi])
                        ns.append(s.wts.size)
                if masks:
                    sels, probs_l = self._eval_heads_resident(
                        adjs_dev, np.asarray(gidx, np.int64),
                        np.asarray(masks), np.asarray(wl), ns)
                    o = 0
                    for (_, s), b in zip(active, batches):
                        s.absorb(b, sels[o: o + len(b)],
                                 probs_l[o: o + len(b)])
                        o += len(b)
                still = []
                for idx, s in active:
                    if s.done:
                        results[idx] = s.result()
                    else:
                        still.append((idx, s))
                active = still
        for idx, s in active:                   # stopped by the deadline
            results[idx] = s.result()
        return results

    def solve_mwis_rollout_wrap(self, adj_0, wts_0, train: bool = False,
                                grd: float = 1.0) -> Tuple[set, float]:
        """The rollout-search entry point (DGCN-RS / CGCN-RS-Seq) through
        the diver tree search: a full search of max_pops = batch_pops = 8
        pops per slot (DISTGCN_SLOT_POPS overrides)."""
        pops = int(os.environ.get("DISTGCN_SLOT_POPS", "8"))
        return self.solve_mwis_bsf(adj_0, wts_0, max_pops=pops,
                                   batch_pops=pops)

    def solve_mwis_iterative(self, adj_0, wts_0, train: bool = False,
                             grd: float = 1.0) -> Tuple[set, float]:
        """Single-pass diver evaluation with the bounded 4-pass backoff
        retry (the cheap rollout path; `solve_mwis_bsf` is the full tree
        search). The D guided LGS runs of a pass are one
        `batched_lgs_multi` call on the graph's one adjacency."""
        adj = sp.csr_matrix(adj_0)
        wts = np.asarray(wts_0, dtype=np.float64).flatten()
        n = wts.size
        state = self.makestate(adj, wts.reshape(-1, 1))
        probs = self.head_scores(state)                 # [N, D]
        d = probs.shape[1]
        gb = state["graph"]
        padded = np.zeros((d, gb.pad_n), dtype=np.float32)
        for k in range(d):
            padded[k, :n] = probs[:, k] * wts

        def heads_lgs(w):
            guided = torch.from_numpy(w[None]).to(self.device)
            return batched_lgs_multi(gb.adj, guided, gb.mask)[0][0].cpu(
            ).numpy()

        sel = heads_lgs(padded)
        best_set, best_util = set(), -np.inf
        for k in range(d):
            s = set(np.nonzero(sel[k, :n] == 1)[0].tolist())
            u = float(wts[list(s)].sum()) if s else 0.0
            if u > best_util:
                best_util, best_set = u, s
        # backoff exploration: with prob backoff_prob per extra pass, re-run
        # the heads with the best set's top node forced out
        rng = self._rng
        passes = 0
        while rng.random() < self.flags.backoff_prob and passes < 4:
            passes += 1
            if not best_set:
                break
            drop = max(best_set, key=lambda v: wts[v])
            w2 = padded.copy()
            w2[:, drop] = -1.0
            sel2 = heads_lgs(w2)
            for k in range(d):
                s = set(np.nonzero(sel2[k, :n] == 1)[0].tolist())
                u = float(wts[list(s)].sum()) if s else 0.0
                if u > best_util:
                    best_util, best_set = u, s
        return best_set, best_util
