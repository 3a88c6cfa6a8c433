"""Ring-partitioned SpMM and LGS: one giant graph across ranks.

Port of `distgcn_tpu/parallel/halo.py`. Rank d of a D-rank process group
owns rows R_d of the support S and features X[R_d]; then

    Y[R_d] = sum_k S[R_d, R_k] @ X[R_k]

is computed in D ring steps: each rank holds one X shard at a time,
multiplies its local column panel against it, and passes the shard to
rank d+1 (`ring_shift`, the JAX ``ppermute`` over ``_ring_perm``: a
`torch.distributed` send to rank+1 and receive from rank-1). At step k the
shard held came from rank (d - k) mod D, exactly the JAX indexing. The
ring takes D-1 shifts: the JAX loop's last ``ppermute`` is dead. With no
process group (or one rank) the ring is this process alone and every
collective is the identity.

`psum` / `pmax` are ``all_reduce``s. `distributed_lgs_ranks` ranks the
nodes for LGS without gathering the weights. `ring_cheb_forward` and
`ring_lgs` are the layer loop and the LGS rounds of every sharded path,
given its panel functions: the dense helpers (`make_ring_spmm`,
`make_sharded_gcn_forward`, `make_sharded_lgs`, plain f32 matmuls, full
f32 by `utils.device.set_f32_matmul_highest`) and the BSR solve of
`parallel.large_sharded`.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from distgcn_tpu_torch.models.layers import identity, leaky_relu02
from distgcn_tpu_torch.parallel.distributed import rank_world


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send `t` to rank+1 and return the tensor received from rank-1 (the
    JAX ``ppermute`` over ``_ring_perm``); `t` itself on a one-rank
    ring."""
    rank, world = rank_world(group)
    if world == 1:
        return t

    def peer(r):
        r %= world
        return r if group is None else dist.get_global_rank(group, r)

    t = t.contiguous()
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, peer(rank + 1), group),
        dist.P2POp(dist.irecv, out, peer(rank - 1), group)])
    for req in reqs:
        req.wait()
    return out


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if rank_world(group)[1] == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks (``jax.lax.psum``)."""
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def pmax(t: torch.Tensor, group=None) -> torch.Tensor:
    """Max over the ranks (``jax.lax.pmax``)."""
    return _all_reduce(t, dist.ReduceOp.MAX, group)


def ring_reduce(x_loc: torch.Tensor,
                panel: Callable[[int, torch.Tensor], torch.Tensor],
                combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                group=None) -> torch.Tensor:
    """combine over the D ring steps of panel(src, shard), where the shard
    held at step k is rank src = (rank - k) mod D's `x_loc`. The first
    step's result is the accumulator: the JAX loop's zero or sentinel
    initial value is the identity of every `combine` used here."""
    rank, d = rank_world(group)
    shard, acc = x_loc, None
    for k in range(d):
        if k:
            shard = ring_shift(shard, group)
        y = panel((rank - k) % d, shard)
        acc = y if acc is None else combine(acc, y)
    return acc


def distributed_lgs_ranks(w_loc: torch.Tensor, group=None) -> torch.Tensor:
    """Distributed `ops.lgs.lgs_ranks`: per-node priority rank under the
    (weight desc, id asc) total order (heuristics.py:106-111 tie-break),
    computed without gathering or sorting the full weight vector.

    w_loc: this rank's [n_loc] f32 weights. Returns int32 ranks [n_loc] in
    [1, n], globally distinct (exact to n < 2^31).

    rank(v) = n - #before(v), where u is before v iff w_u > w_v, or
    w_u == w_v with id_u < id_v. Global ids are shard-major
    (id = rank * n_loc + local), so a cross-shard tie's order is decided
    by the rank alone: a visiting shard's ties count iff its rank is
    lower; this rank's ties are settled by one stable local sort. Each
    visiting shard travels sorted; `torch.searchsorted` counts its values
    below (``right=False``) and at most (``right=True``) each local
    weight, the counts of the JAX package's two-key merge sorts. Weights
    compare as IEEE floats in both (+0.0 == -0.0).
    """
    rank, d = rank_world(group)
    n_loc = w_loc.shape[0]
    # own shard: one stable descending sort gives both the stronger locals
    # and the earlier local ties (stable = id-ascending)
    order = torch.argsort(-w_loc, stable=True)
    before_own = torch.empty_like(order).scatter_(
        0, order, torch.arange(n_loc, device=w_loc.device))

    def before(src, shard):
        if src == rank:
            return before_own
        le = torch.searchsorted(shard, w_loc, right=True)     # w_u <= w_v
        stronger = n_loc - le
        if src > rank:
            return stronger
        lt = torch.searchsorted(shard, w_loc, right=False)    # w_u <  w_v
        return stronger + (le - lt)

    # the shard that travels is sorted; a one-rank ring never reads it
    shard = torch.sort(w_loc).values if d > 1 else w_loc
    total = ring_reduce(shard, before, torch.add, group)
    return (d * n_loc - total).to(torch.int32)


def ring_cheb_forward(h: torch.Tensor, layers, anorm_spmm,
                      max_degree: int = 1,
                      final_act=identity) -> torch.Tensor:
    """ChebGCN layers over this rank's rows: supports [I, L, .., L^K] with
    L = I - Anorm, ``L^k @ y`` as k applications of ``y - anorm_spmm(y)``
    (each a ring reduction). layers: per-layer dicts of f32 tensors
    {'w_0', .., 'w_K', optional 'bias'}; leaky_relu(0.2) between layers,
    `final_act` after the last."""
    for li, layer in enumerate(layers):
        out = h @ layer["w_0"]                                    # S0 = I
        for k in range(1, max_degree + 1):
            y = h @ layer[f"w_{k}"]
            for _ in range(k):                                    # L^k @ y
                y = y - anorm_spmm(y)
            out = out + y
        if "bias" in layer:
            out = out + layer["bias"]
        h = leaky_relu02(out) if li < len(layers) - 1 else final_act(out)
    return h


def ring_lgs(scores: torch.Tensor, w_loc: torch.Tensor,
             mask_loc: torch.Tensor,
             nbr_max_panel: Callable[[int, torch.Tensor], torch.Tensor],
             group=None):
    """Rank-based LGS rounds over a row-partitioned graph (`ops.lgs`
    semantics). Nodes are ranked once (`distributed_lgs_ranks` of
    `scores`); per round each rank takes its rows' maximum remaining
    neighbour rank over the ring, its winners are the rows above it, and
    the winner flags are spread over the ring the same way.

    nbr_max_panel(src, shard) -> per row of this rank, the max of `shard`
    (slab src's int32 keys or f32 flags) over the row's neighbours in slab
    src, below 0 where it has none. Returns (sel_loc [n_loc] int8, util),
    util the selected raw weight `w_loc` summed over every rank.
    Synchronises with the host once per round.
    """
    ranks = distributed_lgs_ranks(scores, group)
    n = rank_world(group)[1] * mask_loc.shape[0]
    sel = torch.where(mask_loc, -1, 0).to(torch.int8)
    rd = 0
    while rd < n and int(psum((sel == -1).any().to(torch.int32),
                              group)) > 0:
        remain = sel == -1
        mx = ring_reduce(torch.where(remain, ranks, -1), nbr_max_panel,
                         torch.maximum, group)
        # no remaining neighbour -> mx < 0 < rank: neighbourless wins
        win = remain & (ranks > mx)
        hit = ring_reduce(win.to(torch.float32), nbr_max_panel,
                          torch.maximum, group) > 0.0
        sel = torch.where(win, torch.ones_like(sel), sel)
        sel = torch.where(remain & ~win & hit, torch.zeros_like(sel), sel)
        rd += 1
    util = psum(torch.where(sel == 1, w_loc, torch.zeros_like(w_loc)).sum(),
                group)
    return sel, util


def make_ring_spmm(n: int, f: int, group=None):
    """Returns spmm(s_loc, x_loc) for a row-partitioned dense support:
    s_loc [n_loc, N] (this rank's rows of S), x_loc [n_loc, F] -> this
    rank's rows of S @ X, [n_loc, F] f32."""
    n_loc = n // rank_world(group)[1]

    def spmm(s_loc: torch.Tensor, x_loc: torch.Tensor) -> torch.Tensor:
        def panel(src, shard):
            return s_loc[:, src * n_loc:(src + 1) * n_loc] @ shard
        return ring_reduce(x_loc, panel, torch.add, group)

    return spmm


def make_sharded_gcn_forward(n: int, feature_size: int, params_list,
                             max_degree: int = 1, group=None):
    """Multi-layer ChebGCN forward over a row-partitioned graph.

    params_list: [{'w_0': [Fin, Fout], ..., 'w_K', optional 'bias'}] per
    layer (array-likes). Supports are [I, L, .., L^K] with
    L = I - D^-1/2 A D^-1/2 (gcn/utils.py:258-274). Returns
    forward(a_loc [n_loc, N] raw 0/1 rows, dis_full [N] deg^-1/2,
    x_loc [n_loc, F]) -> [n_loc, F_out] f32.
    """
    rank, d = rank_world(group)
    n_loc = n // d

    @torch.no_grad()
    def forward(a_loc, dis_full, x_loc):
        row_scale = dis_full[rank * n_loc:(rank + 1) * n_loc]
        lnorm = a_loc * row_scale[:, None] * dis_full[None, :]

        def panel(src, shard):
            return lnorm[:, src * n_loc:(src + 1) * n_loc] @ shard

        layers = [{k: torch.as_tensor(v, dtype=torch.float32,
                                      device=x_loc.device)
                   for k, v in layer.items()} for layer in params_list]
        return ring_cheb_forward(
            x_loc, layers, lambda y: ring_reduce(y, panel, torch.add, group),
            max_degree)

    return forward


def make_sharded_lgs(n: int, group=None):
    """Full LGS over a row-partitioned graph (`ring_lgs` over dense 0/1
    panels). Returns lgs(a_loc [n_loc, N] 0/1 rows, w_loc [n_loc],
    mask_loc [n_loc] bool) -> (sel_loc [n_loc] int8, util), util the
    selected weight summed over every rank. Synchronises with the host
    once per round.
    """
    n_loc = n // rank_world(group)[1]

    @torch.no_grad()
    def lgs(a_loc, w_loc, mask_loc):
        adj = a_loc > 0

        def nbr_max(src, shard):       # -1 where no neighbour
            return torch.where(adj[:, src * n_loc:(src + 1) * n_loc],
                               shard[None, :], -1).amax(dim=1)

        return ring_lgs(w_loc, w_loc, mask_loc, nbr_max, group)

    return lgs
