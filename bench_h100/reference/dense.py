"""The dense closed loop, plainly: a batch of padded conflict graphs, a
T-slot episode from empty queues.

Per slot: queue += arrivals; w = queue x rate on real links; the GCN
scores act (dqn: every slot on features 1 where w != 0; gdpg: once an
episode on features 1, as the features do not depend on w); LGS on
act x w; scheduled links depart. Per graph the episode returns the final
queues and the means over T of the queue sum / real links, the
scheduled utility and the scheduled count / real links.

The ChebGCN layer (gcn/layers.py, K=1, supports [I, L], L = I - Anorm,
Anorm = D^-1/2 A D^-1/2): out = act(x @ W0 + L @ (x @ W1) + b), leaky
ReLU(0.2) on every layer of the gcn2_dqn family. `mm` rounds the operands
of every matrix product (the stated precision: none; the control: TF32).
An episode runs in full float32 whatever the process's TF32 flags say
(`precision.full_f32`).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from bench_h100.reference import lgs, precision, traffic


def supports(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, 2, N, N]: the identity on real nodes, and L = I - Anorm."""
    adj = adj.to(torch.float32)
    n = adj.shape[-1]
    m = mask.to(adj.dtype)
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device) * m[..., None, :]
    eye = eye.expand(adj.shape) * m[..., :, None]
    deg = adj.sum(dim=-1)
    d = torch.where(deg > 0, 1.0 / torch.sqrt(torch.clamp(deg, min=1e-30)),
                    torch.zeros_like(deg))
    anorm = adj * d[..., :, None] * d[..., None, :]
    return torch.stack([eye, eye - anorm], dim=-3)


def forward(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor,
            sup: torch.Tensor, mm: Callable = lambda t: t) -> torch.Tensor:
    """x [B, N, 1] -> [B, N, 1]."""
    lap = sup[:, 1]
    for p in layers:
        out = torch.matmul(mm(x), mm(p["w_0"]))
        out = out + torch.matmul(mm(lap), mm(torch.matmul(mm(x),
                                                          mm(p["w_1"]))))
        if "bias" in p:
            out = out + p["bias"]
        x = F.leaky_relu(out, negative_slope=0.2)
    return x


@precision.in_full_f32
def episode(layers, adj: torch.Tensor, mask: torch.Tensor,
            generator: torch.Generator, timeslots: int, draws,
            feature_mode: str, wt_sel: str = "qr",
            mm: Callable = lambda t: t):
    """One episode from empty queues -> (queueT [B, N], metrics of [B])."""
    m = mask.to(torch.float32)
    adjb = adj > 0
    sup = supports(adj, mask)

    def scores(w):
        nz = m if feature_mode == "gdpg" else m * (w != 0).to(w.dtype)
        x = torch.full(w.shape + (1,), 1.0, dtype=w.dtype,
                       device=w.device) * nz[..., None]
        return forward(layers, x, sup, mm)[..., 0].to(w.dtype) * mask

    act = scores(torch.ones(mask.shape, device=mask.device)) \
        if feature_mode == "gdpg" else None
    stats = torch.empty((timeslots, 3, mask.shape[0]), dtype=torch.float32,
                        device=mask.device)
    queue = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    for t in range(timeslots):
        arrivals, rates = draws(generator, m)
        queue = queue + arrivals
        w = traffic.utilities(queue, rates, wt_sel) * mask
        a = act if act is not None else scores(w)
        sel = lgs.lgs_dense(adjb, a * w, mask)
        queue = traffic.depart(queue, rates, sel)
        stats[t, 0] = (queue * m).sum(dim=-1)
        stats[t, 1] = torch.where(sel == 1, w, torch.zeros_like(w)).sum(-1)
        stats[t, 2] = (sel == 1).to(torch.float32).sum(dim=-1)
    nreal = torch.clamp(m.sum(dim=-1), min=1.0)
    return queue, {"avg_queue_len": stats[:, 0].mean(dim=0) / nreal,
                   "avg_utility": stats[:, 1].mean(dim=0),
                   "sched_rate": stats[:, 2].mean(dim=0) / nreal}
