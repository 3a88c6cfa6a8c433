"""The TWC paper's wireless evaluation, plainly: a batch of padded link
conflict graphs (one per channel), a T-slot episode from empty queues at
one load, qr utilities (queue x rate).

Single channel (`episode_single`, wireless_dqn_test.py): per slot
queue += arrivals; w = queue x rate on real links; LGS on act x w, act the
GCN's scores, computed once an episode on features 1 on the real links
(gdpg: the features do not depend on w); the scheduled links depart
min(queue, rate). Beside it the greedy baseline: LGS on w itself, its
utility summed in float64 and rounded once to float32. Per network the
episode returns the final queues and the means over T of the queue sum /
real links, the scheduled utility, the scheduled count / real links and
the scheduled utility over max(baseline, 1e-9).

Sequential, DGCN-LGS-Seq (`episode_seq`, wireless_dqn_test_mc.py:292-354):
per slot queue += arrivals, q_est = queue; then for each channel c in
order: w = q_est x rate_c; the links with w > 0 form the channel's
subgraph, the others deleted (their rows and columns of channel c's graph
zeroed, so the degrees, the normalisation and the identity cover the
subgraph alone); the GCN on that subgraph, features 1 on it; LGS on
act x w over the subgraph; each scheduled link's drain estimate
min(q_est, rate_c) leaves q_est before the next channel. A link's capacity
in the slot is the sum of the rates of the channels it was scheduled on,
and the queue departs min(queue, capacity). Per network: the final queues
and the means over T of the queue sum / real links and of the scheduled
utility. LGS-Seq is the same with LGS on w.

Draws come from the episode's `torch.Generator` in the program's order:
arrivals [B, N] (the inverse CDF of one uniform, `traffic.Draws`), then
rates [B, N] for one channel or [B, N, n_ch] for several, one call each of
the whole shape. The GCN and LGS are `dense.forward`, `dense.supports`
and `lgs.lgs_dense`; nothing of the program is used. Episodes run in full
float32 whatever the process's TF32 flags say; `mm` rounds the operands
of every matrix product (the control).
"""

from __future__ import annotations

from typing import Callable

import torch

from bench_h100.reference import dense, lgs, precision, traffic


class ChannelDraws(traffic.Draws):
    """draw(generator, m) -> (arrivals [B, N], rates [B, N, n_ch]), zero
    where the float mask `m` is 0."""

    def __init__(self, load: float, rate_lo: float, rate_hi: float,
                 n_ch: int, device):
        super().__init__(load, rate_lo, rate_hi, device)
        self.n_ch = n_ch

    def __call__(self, generator: torch.Generator, m: torch.Tensor):
        u = torch.rand(m.shape, generator=generator, device=m.device)
        arrivals = torch.searchsorted(self.cdf, u).to(m.dtype) * m
        g = torch.randn(m.shape + (self.n_ch,), generator=generator,
                        device=m.device)
        rates = torch.clamp(torch.trunc(g * self.std + self.mean), self.lo,
                            self.hi) * m[..., None]
        return arrivals, rates


def _scores(layers, adj: torch.Tensor, keep: torch.Tensor,
            mm: Callable) -> torch.Tensor:
    """The GCN's scores [B, N] on the subgraph of the nodes `keep` (the
    others' rows and columns zeroed), features 1 on it, 0 elsewhere."""
    k = keep.to(torch.float32)
    sub = adj.to(torch.float32) * k[..., :, None] * k[..., None, :]
    x = torch.full(keep.shape + (1,), 1.0, device=keep.device) * k[..., None]
    return dense.forward(layers, x, dense.supports(sub, keep), mm)[..., 0] \
        * keep


def _baseline_util(sel: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    on = sel == 1
    return torch.where(on, w.to(torch.float64),
                       torch.zeros_like(w, dtype=torch.float64)).sum(
        dim=-1).to(torch.float32)


@precision.in_full_f32
def episode_single(layers, adj: torch.Tensor, mask: torch.Tensor,
                   generator: torch.Generator, timeslots: int, draws,
                   mm: Callable = lambda t: t):
    """One single-channel episode with the greedy baseline, from empty
    queues -> (queueT [B, N], metrics of [B])."""
    m = mask.to(torch.float32)
    adjb = adj > 0
    act = _scores(layers, adj, mask, mm)
    stats = torch.empty((timeslots, 4, mask.shape[0]), dtype=torch.float32,
                        device=mask.device)
    queue = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    for t in range(timeslots):
        arrivals, rates = draws(generator, m)
        queue = queue + arrivals
        w = traffic.utilities(queue, rates, "qr") * mask
        sel = lgs.lgs_dense(adjb, act * w, mask)
        queue = traffic.depart(queue, rates, sel)
        stats[t, 0] = (queue * m).sum(dim=-1)
        stats[t, 1] = torch.where(sel == 1, w, torch.zeros_like(w)).sum(-1)
        stats[t, 2] = (sel == 1).to(torch.float32).sum(dim=-1)
        stats[t, 3] = _baseline_util(lgs.lgs_dense(adjb, w, mask), w)
    nreal = torch.clamp(m.sum(dim=-1), min=1.0)
    return queue, {
        "avg_queue_len": stats[:, 0].mean(dim=0) / nreal,
        "avg_utility": stats[:, 1].mean(dim=0),
        "sched_rate": stats[:, 2].mean(dim=0) / nreal,
        "avg_utility_ratio": (stats[:, 1] / torch.clamp(stats[:, 3],
                                                        min=1e-9)).mean(0)}


@precision.in_full_f32
def episode_seq(layers, adj_ch: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator, timeslots: int, draws,
                use_gcn: bool = True, mm: Callable = lambda t: t):
    """One sequential episode on the per-channel graphs adj_ch
    [B, n_ch, N, N], from empty queues -> (queueT [B, N], metrics of
    [B])."""
    m = mask.to(torch.float32)
    n_ch = adj_ch.shape[1]
    chans = [adj_ch[:, c] for c in range(n_ch)]
    stats = torch.empty((timeslots, 2, mask.shape[0]), dtype=torch.float32,
                        device=mask.device)
    queue = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    for t in range(timeslots):
        arrivals, rates = draws(generator, m)
        queue = queue + arrivals
        q_est = queue
        capacity = torch.zeros_like(queue)
        util = torch.zeros(mask.shape[:1], dtype=torch.float32,
                           device=mask.device)
        for c, adj in enumerate(chans):
            r = rates[:, :, c]
            w = q_est * r
            keep = mask & (w > 0)
            a = _scores(layers, adj, keep, mm) * w if use_gcn else w
            sel = lgs.lgs_dense(adj > 0, a, keep)
            on = (sel == 1).to(torch.float32)
            util = util + (w * on).sum(dim=-1)
            capacity = capacity + r * on
            q_est = q_est - torch.minimum(q_est, r) * on
        queue = queue - torch.minimum(queue, capacity)
        stats[t, 0] = (queue * m).sum(dim=-1)
        stats[t, 1] = util
    nreal = torch.clamp(m.sum(dim=-1), min=1.0)
    return queue, {"avg_queue_len": stats[:, 0].mean(dim=0) / nreal,
                   "avg_utility": stats[:, 1].mean(dim=0)}
