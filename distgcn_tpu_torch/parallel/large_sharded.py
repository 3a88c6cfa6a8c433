"""Giant-graph scale-out: 0/1 structure panels and the BSR kernels over a
ring of ranks.

Port of `distgcn_tpu/parallel/large_sharded.py`. The adjacency's BSR
blocks are partitioned into a [D, D] grid of panels: rank d owns block-row
slab d, and panel (d, s) holds its blocks whose block-column falls in slab
s. Feature shards travel the ring (`parallel.halo.ring_shift`); at ring
step k each rank multiplies, or neighbour-max-reduces, its panel against
the shard it holds, so peak memory is N*F/D plus its slab of blocks. This
lifts the single-card path's 2^24-node cap (`large.bsr_lgs`): LGS ranks
ride the ring as int32.

For 0/1 adjacencies normalize_adj is separable, Anorm = diag(r) A diag(r)
with r = deg^-1/2, so the forward streams only the structure panels (int8,
or bitmap words when bs % 32 == 0): the travelling shard is pre-scaled by
its home slab's r, the ring accumulates A @ (r ⊙ y) through the SpMM
kernel, and the owner applies r ⊙ (·). The SpMM and both LGS
neighbour-maxes share the one structure stream. Weighted adjacencies add
Anorm's values on that stream (each panel's edge form,
`ops.spmm.EdgeValues`): one value per set bit of the structure panel.

Per ring step, on CUDA tensors (the plain versions on CPU tensors):
`ops.spmm.spmm_rows` (the SpMM kernel, `csrc/bsr_spmm.cu`; weighted:
`ops.spmm.edge_spmm_rows`, the same kernel) for each support
application, `ops.spmm.nbr_max_rows` with an int32 payload (the int32
neighbour-max kernel, `csrc/bsr_nbr_max.cu`) for the remaining-rank max,
and with an f32 payload (the f32 neighbour-max kernel) for the winner
spread. The JAX package pads F to 128 lanes for its TPU kernels; the
Hopper kernels take any F, so nothing is padded here.

The JAX package runs the LGS rounds in a ``while_loop``; here the
"any node remaining" test is an ``all_reduce`` and one host read per
round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.models.layers import identity, leaky_relu02
from distgcn_tpu_torch.ops.spmm import (EdgeValues, edge_runs,
                                        edge_spmm_rows, nbr_max_rows,
                                        spmm_rows)
from distgcn_tpu_torch.parallel.distributed import rank_world
from distgcn_tpu_torch.parallel.halo import (pmax, ring_cheb_forward,
                                             ring_lgs, ring_reduce)
from distgcn_tpu_torch.utils.device import resolve_device


@dataclass
class ShardedLargeGraph:
    """BSR panels of A (structure) partitioned [D, D]; slab d = rows of
    rank d. `ind` always exists (the LGS operand and the SpMM's
    structure); `vals` (Anorm value panels, which no solve reads) and
    `evals` / `eoff` (Anorm's values on the `ind` panels, the SpMM's
    operand) only for non-separable normalizations. Host (numpy)
    arrays."""
    n: int            # real node count
    n_pad: int        # multiple of d * block_size
    n_loc: int        # n_pad // d
    d: int
    block_size: int
    nb_max: int       # per-panel block count (padded uniform)
    # [D, D, nr_loc+1] / [D, D, nb_max]
    rptr: np.ndarray
    cols: np.ndarray
    mask: np.ndarray  # [n_pad] bool
    # 0/1 structure panels: int8 [D, D, nb_max, bs, bs], or when
    # bs % 32 == 0 bitmap int32 [D, D, nb_max, bs//32, bs]
    # (`ops.spmm.pack_bits_blocks` layout)
    ind: np.ndarray = None
    bitmap: bool = False
    # r = deg^-1/2 per node [n_pad] f32 (separable graphs)
    r: Optional[np.ndarray] = None
    # f32 Anorm value panels [D, D, nb_max, bs, bs], non-separable only
    vals: Optional[np.ndarray] = None
    separable: bool = True
    # each panel's edge form (`ops.spmm.EdgeValues`), non-separable only:
    # f32 values [D, D, nnz_max] (zero past the panel's count) and int32
    # run offsets [D, D, nb_max * ceil(bs/32) + 1] (constant past rptr[-1])
    evals: Optional[np.ndarray] = None
    eoff: Optional[np.ndarray] = None

    @property
    def nnz_blocks(self) -> int:
        """Real (streamed) block count = what rptr addresses."""
        return int(self.rptr[:, :, -1].sum())

    def bytes_per_edge(self, nnz: int, f: int = 128,
                       n_layers: int = 1) -> float:
        """Streamed device-memory bytes per real directed edge for one
        forward pass: the panel blocks (read once per layer per ring sweep)
        plus the f32 activation shard read and accumulator update per ring
        step. The JAX package's accounting: for a weighted graph it counts
        the value panels, where the port's solve streams the edge form."""
        bs = self.block_size
        cell_bytes = (0.125 if self.bitmap else 1) if self.separable \
            else self.vals.dtype.itemsize
        blocks = self.nnz_blocks * bs * bs * cell_bytes
        acts = self.d * self.n_pad * f * 4 * 2   # z in + acc rmw per step
        return n_layers * (blocks + acts) / max(nnz, 1)


def shard_large_graph(adj, n_devices: int, block_size: int = 512
                      ) -> ShardedLargeGraph:
    """Partition A's structure (and, for non-separable normalizations, the
    normalize_adj(A) values in f32, as value panels and as each panel's
    edge form) into the [D, D] panel grid, on the host. The JAX package's
    ``block_dtype`` and ``value_blocks`` are not taken: values are f32,
    the type the solve reads, and exist exactly for weighted graphs."""
    adj = sp.csr_matrix(adj)
    n = adj.shape[0]
    bs, d = block_size, n_devices
    n_pad = -(-n // (bs * d)) * (bs * d)
    nr_loc = n_pad // (bs * d)
    separable = bool(adj.nnz == 0 or np.all(adj.data == 1))
    anorm = sp.coo_matrix(prep.normalize_adj(adj))
    br = (anorm.row // bs).astype(np.int64)       # int64: key has ~4 index
    bc = (anorm.col // bs).astype(np.int64)       # factors and would wrap
    pr, ps = br // nr_loc, bc // nr_loc           # panel coordinates
    lbr, lbc = br % nr_loc, bc % nr_loc           # block ids local to panel
    key = ((pr * d + ps) * nr_loc + lbr) * nr_loc + lbc
    uniq, inv = np.unique(key, return_inverse=True)
    nb_per_panel = np.bincount(uniq // (nr_loc * nr_loc), minlength=d * d)
    nb_max = max(int(nb_per_panel.max()), 1)
    cols = np.zeros((d, d, nb_max), np.int32)
    rptr = np.zeros((d, d, nr_loc + 1), np.int32)
    # position of each unique block within its panel (uniq is sorted, so
    # blocks of one panel are contiguous: offset from the panel's start)
    panel_of = uniq // (nr_loc * nr_loc)
    panel_start = np.searchsorted(panel_of, np.arange(d * d))
    pos_in_panel = np.arange(uniq.size, dtype=np.int64) - panel_start[panel_of]
    u_pr = panel_of // d
    u_ps = panel_of % d
    u_lbr = (uniq // nr_loc) % nr_loc
    u_lbc = uniq % nr_loc
    cols[u_pr, u_ps, pos_in_panel] = u_lbc.astype(np.int32)
    bitmap = bs % 32 == 0
    if bitmap:
        # pack straight from COO: the int8 panels are never built
        ind = np.zeros((d, d, nb_max, bs // 32, bs), np.uint32)
        lr = (anorm.row % bs).astype(np.uint32)
        np.bitwise_or.at(
            ind, (u_pr[inv], u_ps[inv], pos_in_panel[inv], lr // 32,
                  anorm.col % bs), np.uint32(1) << (lr % 32))
        ind = ind.view(np.int32)
    else:
        ind = np.zeros((d, d, nb_max, bs, bs), np.int8)
        ind[u_pr[inv], u_ps[inv], pos_in_panel[inv],
            anorm.row % bs, anorm.col % bs] = 1
    vals = evals = eoff = None
    if not separable:
        vals = np.zeros((d, d, nb_max, bs, bs), np.float32)
        vals[u_pr[inv], u_ps[inv], pos_in_panel[inv],
             anorm.row % bs, anorm.col % bs] = anorm.data
        # the edge form over every panel's blocks at once (panel p's blocks
        # numbered p * nb_max + position), then cut per panel
        runs = nb_max * -(-bs // 32)
        ev, off = edge_runs(panel_of[inv] * nb_max + pos_in_panel[inv],
                            anorm.row % bs, anorm.col % bs,
                            anorm.data.astype(np.float32), bs,
                            d * d * nb_max)
        cnt = np.diff(off[::runs])
        evals = np.zeros((d, d, max(int(cnt.max()), 1)), np.float32)
        eoff = np.zeros((d, d, runs + 1), np.int32)
        for p in range(d * d):
            lo = off[p * runs]
            eoff[p // d, p % d] = off[p * runs:(p + 1) * runs + 1] - lo
            evals[p // d, p % d, :cnt[p]] = ev[lo:lo + cnt[p]]
    for p in range(d * d):
        sel = panel_of == p
        cnt = np.bincount(u_lbr[sel], minlength=nr_loc)
        rptr[p // d, p % d] = np.concatenate(
            [[0], np.cumsum(cnt)]).astype(np.int32)
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    r = None
    if separable:
        # d_inv_sqrt exactly as normalize_adj computes it (float64 power)
        rowsum = np.asarray(adj.sum(1)).ravel()
        with np.errstate(divide="ignore"):
            rv = np.power(rowsum, -0.5)
        rv[np.isinf(rv)] = 0.0
        r = np.zeros(n_pad, np.float32)
        r[:n] = rv
    return ShardedLargeGraph(n=n, n_pad=n_pad, n_loc=n_pad // d, d=d,
                             block_size=bs, nb_max=nb_max, rptr=rptr,
                             cols=cols, mask=mask, ind=ind, bitmap=bitmap,
                             r=r, vals=vals, separable=separable,
                             evals=evals, eoff=eoff)


def _check_world(graph: ShardedLargeGraph, group) -> int:
    rank, world = rank_world(group)
    if world != graph.d:
        raise ValueError(f"the graph is sharded for {graph.d} ranks, the "
                         f"process group has {world}")
    return rank


def make_sharded_large_solve(graph: ShardedLargeGraph, feature_size: int = 1,
                             max_degree: int = 1, predict: str = "mwis",
                             final_act_same: bool = False, device=None,
                             group=None):
    """Sharded solve(a1, a2, a3, a4, params_list, wts_loc, mask_loc) ->
    (sel_loc, util) on this rank's slab: features -> L-layer ChebGCN (ring
    SpMM over the panels) -> rank-based LGS (ring neighbour-max rounds).

    The four leading arguments are `shard_arrays`' slab: (ind, rptr,
    cols, r) for separable graphs, (edge, rptr, cols, ind) for weighted
    graphs. params_list: per-layer dicts of f32 tensors on the slab's
    device (`large.params_to_list`). wts_loc [n_loc] f32 and mask_loc
    [n_loc] bool are this rank's rows. Returns sel_loc [n_loc] int8 and
    util, the selected weight summed over every rank. Every tensor lies on
    `device` (CUDA unless the caller passes ``device="cpu"``). The process
    group (`group`, default the whole world; none = a one-rank ring) must
    have graph.d ranks. Synchronises with the host once per LGS round.
    """
    _check_world(graph, group)
    dev = resolve_device(device)
    n_loc, bs = graph.n_loc, graph.block_size
    separable, bmp = graph.separable, graph.bitmap
    final_act = leaky_relu02 if final_act_same else identity

    @torch.no_grad()
    def solve(a1, a2, a3, a4, params_list, wts_loc, mask_loc):
        first = a1 if separable else a1.vals
        for t in (first, a2, a3, a4, wts_loc, mask_loc):
            if t.device.type != dev.type:
                raise ValueError(f"the solve runs on {dev}, got a tensor "
                                 f"on {t.device}")
        if separable:
            ind, rptr, cols, r_loc = a1, a2, a3, a4[:, None]
        else:
            edge, rptr, cols, ind = a1, a2, a3, a4

        def spmm_panel(src, shard):
            if separable:
                return spmm_rows(ind[src], rptr[src], cols[src], shard,
                                 n_loc, bs, bmp)
            return edge_spmm_rows(
                EdgeValues(ind[src], edge.vals[src], edge.off[src]),
                rptr[src], cols[src], shard, n_loc, bs)

        def nbr_max_panel(src, shard):
            # f32 (winner spread) or int32 (rank max, exact past 2^24);
            # rows with no neighbour in the panel get the (negative)
            # sentinel
            return nbr_max_rows(ind[src], rptr[src], cols[src], shard, n_loc,
                                bs, bmp)

        def anorm_spmm(y):
            if separable:
                # Anorm @ y = r ⊙ ringsum_s A[my, s] @ (r_s ⊙ y_s)
                y = y * r_loc
            out = ring_reduce(y, spmm_panel, torch.add, group)
            return out * r_loc if separable else out

        # ---- features (mwis_gdpg_call.py:82-97 semantics)
        m = mask_loc.to(torch.float32)
        if predict == "mwis":
            feats = torch.full((n_loc, feature_size), 1.0 / feature_size,
                               dtype=torch.float32,
                               device=m.device) * m[:, None]
        else:
            norm = pmax((wts_loc.abs() * m).max(), group) + 1e-9
            feats = (wts_loc / norm)[:, None].repeat(1, feature_size) \
                * m[:, None]

        # ---- L-layer ChebGCN forward, then rank-based LGS rounds, both
        # over the ring
        h = ring_cheb_forward(feats, params_list, anorm_spmm, max_degree,
                              final_act)
        act = h[:, 0] * m
        gcn_wts = act * wts_loc if predict == "mwis" else act
        return ring_lgs(gcn_wts, wts_loc, mask_loc, nbr_max_panel, group)

    return solve


def shard_arrays(graph: ShardedLargeGraph, device=None, group=None):
    """This rank's slab of the panel arrays and the mask, on `device`:
    (ind, rptr, cols, r, mask) for separable graphs, (edge, rptr, cols,
    ind, mask) otherwise, where edge is the slab's `ops.spmm.EdgeValues`
    (words: the ind slab itself, vals [D, nnz_max], off [D, runs + 1]).
    The value panels stay on the host."""
    rank = _check_world(graph, group)
    dev = resolve_device(device)
    lo, hi = rank * graph.n_loc, (rank + 1) * graph.n_loc

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mask = put(graph.mask[lo:hi])
    if graph.separable:
        return (put(graph.ind[rank]), put(graph.rptr[rank]),
                put(graph.cols[rank]), put(graph.r[lo:hi]), mask)
    ind = put(graph.ind[rank])
    edge = EdgeValues(ind, put(graph.evals[rank]), put(graph.eoff[rank]))
    return (edge, put(graph.rptr[rank]), put(graph.cols[rank]), ind, mask)
