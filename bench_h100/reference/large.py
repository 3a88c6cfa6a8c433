"""One slot on one large conflict graph, plainly, in neighbour-list form.

The graph comes from the benchmark's scipy adjacency: for each link its
conflicting links (padded to the largest degree, with a valid mask), and
Anorm = D^-1/2 A D^-1/2 on them (float64, then float32).

Two forwards of the same ChebGCN layer, out = act(x @ W0 + L @ (x @ W1)
+ b) with L = I - Anorm, leaky ReLU(0.2) on the hidden layers and a linear
head (the large path's head):

- `forward_fused`, the stated precision of the fused route on a 0/1
  graph, written as the fused route writes the layer,
  out = act(x @ (W0 + W1) + b - r * ((A @ (r * x)) @ W1)), r = deg^-1/2:
  the layer input x, the column scale r of the A-product and both
  factors of the row scaling r * lag rounded by `act_round` (bfloat16;
  the control fp8), every product and sum in float32;
- `forward_exact`, the exact route of a weighted graph: float32
  throughout, `mm` rounding the operands of the W-products (the control:
  TF32).

A slot: queue += arrivals; w = queue x rate; features 1 where w != 0; act
= the head's output; LGS on act x w; scheduled links depart. A slot runs
in full float32 whatever the process's TF32 flags say
(`precision.full_f32`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from bench_h100.reference import lgs, precision, traffic


@dataclass
class Graph:
    n: int
    nbr: torch.Tensor        # [n, K] int64 (padding points at the node)
    valid: torch.Tensor      # [n, K] bool
    vals: torch.Tensor       # [n, K] float32 Anorm values (0 on padding)
    r: torch.Tensor          # [n] float32 deg^-1/2 of the 0/1 structure
    mask: torch.Tensor       # [n] bool


def graph(adj: sp.spmatrix, device) -> Graph:
    a = sp.csr_matrix(adj, dtype=np.float64)
    a.sort_indices()
    n = a.shape[0]
    deg = np.diff(a.indptr)
    k = max(int(deg.max()), 1)
    rows = np.repeat(np.arange(n), deg)
    slot = np.arange(a.nnz) - np.repeat(a.indptr[:-1], deg)
    nbr = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, k))
    valid = np.zeros((n, k), bool)
    nbr[rows, slot] = a.indices
    valid[rows, slot] = True
    wsum = np.asarray(a.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        dw = np.where(wsum > 0, wsum ** -0.5, 0.0)
        r = np.where(deg > 0, deg.astype(np.float64) ** -0.5, 0.0)
    vals = np.zeros((n, k), np.float64)
    vals[rows, slot] = a.data * dw[rows] * dw[a.indices]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return Graph(n=n, nbr=t(nbr), valid=t(valid),
                 vals=t(vals.astype(np.float32)), r=t(r.astype(np.float32)),
                 mask=torch.ones(n, dtype=torch.bool, device=device))


def _gather_sum(g: Graph, coef: torch.Tensor, y: torch.Tensor):
    """sum_k coef[i, k] * y[nbr[i, k]] in the neighbour order: [n, F]."""
    return (coef[:, :, None] * y[g.nbr]).sum(dim=1)


def forward_fused(g: Graph, layers: List[Dict[str, torch.Tensor]],
                  x: torch.Tensor, act_round: Callable) -> torch.Tensor:
    """x [n, 1] float32 -> the head's output [n, 1] float32."""
    rr = act_round(g.r)
    rcol = torch.where(g.valid, rr[g.nbr], torch.zeros_like(rr[g.nbr]))
    nl = len(layers)
    for li, p in enumerate(layers):
        x = act_round(x)
        acc = _gather_sum(g, rcol, x)
        y = x @ (p["w_0"] + p["w_1"])
        lag = acc @ p["w_1"]
        out = y - rr[:, None] * act_round(lag)
        if "bias" in p:
            out = out + p["bias"]
        x = F.leaky_relu(out, negative_slope=0.2) if li < nl - 1 else out
    return x


def forward_exact(g: Graph, layers: List[Dict[str, torch.Tensor]],
                  x: torch.Tensor, mm: Callable) -> torch.Tensor:
    nl = len(layers)
    for li, p in enumerate(layers):
        out = mm(x) @ mm(p["w_0"])
        y = mm(x) @ mm(p["w_1"])
        out = out + (y - _gather_sum(g, g.vals, y))
        if "bias" in p:
            out = out + p["bias"]
        x = F.leaky_relu(out, negative_slope=0.2) if li < nl - 1 else out
    return x


@precision.in_full_f32
def slot(g: Graph, forward: Callable, queue: torch.Tensor,
         arrivals: torch.Tensor, rates: torch.Tensor, wt_sel: str = "qr"):
    """One slot from `queue` -> (queue', utility, scheduled count, sel)."""
    m = g.mask.to(torch.float32)
    q = queue + arrivals
    w = traffic.utilities(q, rates, wt_sel) * m
    x = (torch.ones((g.n, 1), device=m.device) * m[:, None]
         * (w != 0).to(torch.float32)[:, None])
    act = forward(x)[:, 0] * m
    sel = lgs.lgs_ell(g.nbr, g.valid, act * w, g.mask)
    util = torch.where(sel == 1, w, torch.zeros_like(w)).sum()
    return traffic.depart(q, rates, sel), util, (sel == 1).sum(), sel
