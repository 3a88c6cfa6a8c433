"""Local greedy search (heuristics.py:77-116): synchronized rounds in
which a remaining node joins the set iff its key (weight, -index) beats
every remaining neighbour's, and the winners' remaining neighbours leave.

Keys are exact int64s: the weight's float32 order in the high half (+0
and -0 one value), the reversed node index in the low half, so a tie in
weight goes to the smaller index. No rank, sort or kernel of the program
is used. States: -1 remaining, 0 out (or padding), 1 selected.
"""

from __future__ import annotations

import torch

_LOW = (1 << 32) - 1


def keys(w: torch.Tensor) -> torch.Tensor:
    """int64 keys of float32 weights [..., n] along the last axis."""
    w = w.to(torch.float32) + 0.0               # -0.0 + 0.0 == +0.0
    b = w.contiguous().view(torch.int32).to(torch.int64)
    order = torch.where(b >= 0, b, -(b & 0x7FFFFFFF))
    idx = torch.arange(w.shape[-1], device=w.device, dtype=torch.int64)
    return order * (1 << 32) + (_LOW - idx)


def lgs_dense(adjb: torch.Tensor, w: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """adjb [B,N,N] bool, w [B,N] float32, mask [B,N] bool -> sel [B,N]
    int8."""
    k = keys(w)
    beaten = adjb & (k[:, None, :] > k[:, :, None])   # [b, v, u]: u beats v
    sel = torch.where(mask, -1, 0).to(torch.int8)
    while bool((sel == -1).any()):
        remain = sel == -1
        win = remain & ~(beaten & remain[:, None, :]).any(dim=-1)
        out = remain & ~win & (adjb & win[:, None, :]).any(dim=-1)
        sel = torch.where(win, torch.ones_like(sel), sel)
        sel = torch.where(out, torch.zeros_like(sel), sel)
    return sel


def lgs_ell(nbr: torch.Tensor, valid: torch.Tensor, w: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """One graph in neighbour-list form: nbr [n, K] int64 and valid [n, K]
    bool, w [n] float32, mask [n] bool -> sel [n] int8."""
    k = keys(w)
    beaten = valid & (k[nbr] > k[:, None])
    sel = torch.where(mask, -1, 0).to(torch.int8)
    while bool((sel == -1).any()):
        remain = sel == -1
        win = remain & ~(beaten & remain[nbr]).any(dim=-1)
        out = remain & ~win & (valid & win[nbr]).any(dim=-1)
        sel = torch.where(win, torch.ones_like(sel), sel)
        sel = torch.where(out, torch.zeros_like(sel), sel)
    return sel
