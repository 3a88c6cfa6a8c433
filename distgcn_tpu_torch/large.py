"""Large-graph pipeline: one city-scale conflict graph on the card.

Port of `distgcn_tpu/large.py`. The dense batched path (`pipeline.py`)
covers graphs of N <= ~1e3; this module is the large-N path (N ~ 1e4..1e6):

    weights -> features -> L-layer ChebGCN -> GCN weights -> LGS
            -> schedule + utility

Support semantics match the reference: supports [I, L, ..., L^K] with
L = I - normalize_adj(A), and ``L^k @ y`` is k applications of
``y - Anorm @ y`` (L^k is never built).

Routes, as in the JAX package; a graph holds the arrays of its route
only (`LargeGraph`):

- BSR (``use_bsr``, the default on a CUDA device): A's structure blocks
  (bitmap at an inner block of ``min(block_size, 256)``). For 0/1
  adjacencies (every conflict graph) the normalization is separable,
  Anorm = diag(r) A diag(r), so the blocks and ``r`` are all the device
  holds; a weighted Anorm adds its edge form on the same blocks. With K=1
  each GCN layer is one fused-layer kernel (`ops/cheb_fused.py`); K>1,
  weighted adjacencies and ``fused=False`` go through the BSR SpMM
  (`ops.spmm.bsr_spmm_rows`; a weighted Anorm as its edge form on the
  structure blocks, `ops.spmm.edge_spmm_rows`), and the LGS streams the
  same blocks through the neighbour-max (`bsr_lgs`). On CUDA tensors these
  launch the three CUDA kernels; on CPU tensors their plain versions run.
- ELL (``use_bsr=False``): Anorm as ELLPACK arrays, the gather SpMM
  (`ops.spmm.ell_spmm`) and the gather LGS (`ops.lgs.ell_lgs`), on
  either device.

Feature semantics match `mwis_gdpg_call.py:82-97` (makestate):
predict='mwis' -> ones / F; else w / max(w) broadcast.

The JAX package runs a solve as one jitted program with a `while_loop`;
here `bsr_lgs` reads the device's counts of nodes left once per batch of
rounds (a batch usually holds the whole solve), and `ell_lgs` once per
round.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.models.layers import identity, leaky_relu02
from distgcn_tpu_torch.ops.cheb_fused import fused_forward, pad_params
from distgcn_tpu_torch.ops.lgs import ell_lgs, lgs_order
from distgcn_tpu_torch.ops.spmm import (BsrMatrix, EdgeValues,
                                        bsr_row_ptr, bsr_spmm_rows,
                                        edge_spmm_rows, edge_values_coo,
                                        ell_pack, ell_spmm, lgs_round_passes)
from distgcn_tpu_torch.sim.device_sim import (make_poisson_arrivals,
                                              slot_utilities)
from distgcn_tpu_torch.utils.device import resolve_device
from distgcn_tpu_torch.utils.profiling import span


@dataclass
class LargeGraph:
    """One large conflict graph, preprocessed for the device pipeline.

    Each route holds only what its solves read. The ELL route holds
    Anorm = normalize_adj(A) as ELLPACK cols/vals/valid (the gather SpMM
    and the ELL LGS). The BSR route holds A's 0/1 structure blocks (the
    fused layer, the SpMM and the LGS) and either ``r`` (a separable
    normalization, Anorm = diag(r) A diag(r)) or ``edge``, Anorm's values
    on the structure blocks (the SpMM's operand for a weighted A).
    """
    n: int                      # real node count
    n_pad: int                  # padded (multiple of block_size)
    nnz: int                    # directed edge count of A
    block_size: int
    mask: torch.Tensor          # [n_pad] bool
    ell_cols: Optional[torch.Tensor] = None   # [n_pad, K] int32
    ell_vals: Optional[torch.Tensor] = None   # [n_pad, K] f32 (0 = padding)
    ell_valid: Optional[torch.Tensor] = None  # [n_pad, K] bool (real edges)
    ind_bsr: Optional[BsrMatrix] = None      # A's 0/1 structure blocks
    ind_row_ptr: Optional[torch.Tensor] = None
    bitmap: bool = False                     # ind_bsr is bitmap-packed
    r: Optional[torch.Tensor] = None         # [n_pad, 1] f32 = deg^-1/2
    separable: bool = False
    edge: Optional[EdgeValues] = None        # Anorm's values on ind_bsr
    lgs_state: Optional["LgsState"] = None   # `bsr_lgs`'s, made at first use

    @property
    def use_bsr(self) -> bool:
        return self.ind_bsr is not None


def build_large_graph(adj, block_size: int = 512,
                      use_bsr: Optional[bool] = None,
                      device=None) -> LargeGraph:
    """Preprocess a scipy adjacency into a `LargeGraph` on `device`.

    Keep the graph locality-ordered (`geometric_conflict_graph`'s orders)
    before calling: the number of touched blocks, and with it the kernels'
    work, depends on it. ``use_bsr`` defaults to True on a CUDA device.
    ``use_bsr=False`` builds the ELL arrays only. The BSR route builds
    the structure blocks, ``min(block_size, 256)`` wide and bitmap-packed
    when that is a multiple of 32, with ``r`` for a 0/1 adjacency or, for
    a weighted one, Anorm's edge form on those blocks (from its COO, on
    the host).
    """
    dev = resolve_device(device)
    adj = sp.csr_matrix(adj)
    n = adj.shape[0]
    anorm = sp.csr_matrix(prep.normalize_adj(adj))
    separable = bool(adj.nnz == 0 or np.all(adj.data == 1))
    if use_bsr is None:
        use_bsr = dev.type == "cuda"
    n_pad = -(-n // block_size) * block_size
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    g = LargeGraph(n=n, n_pad=n_pad, nnz=int(adj.nnz), block_size=block_size,
                   mask=torch.from_numpy(mask).to(dev), separable=separable)
    if not use_bsr:
        cols, vals = ell_pack(anorm)
        k = cols.shape[1]
        cols_p = np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, k))
        vals_p = np.zeros((n_pad, k), np.float32)
        cols_p[:n] = cols
        vals_p[:n] = vals
        g.ell_cols = torch.from_numpy(cols_p).to(dev)
        g.ell_vals = torch.from_numpy(vals_p).to(dev)
        g.ell_valid = torch.from_numpy(vals_p != 0).to(dev)
        return g
    ibs = min(block_size, 256)
    if n_pad % ibs:
        raise ValueError(f"the structure block min(block_size, 256)={ibs} "
                         f"must divide n_pad={n_pad}")
    ind = anorm.copy()
    ind.data[:] = 1.0          # structure only
    ind.resize(n_pad, n_pad)
    g.bitmap = ibs % 32 == 0
    g.ind_bsr = BsrMatrix.from_scipy(
        ind, ibs, dtype="bits" if g.bitmap else np.int8, device=dev)
    g.ind_row_ptr = bsr_row_ptr(g.ind_bsr)
    if separable:
        # d_inv_sqrt exactly as normalize_adj computes it (float64 power)
        rowsum = np.asarray(adj.sum(1)).ravel()
        with np.errstate(divide="ignore"):
            r = np.power(rowsum, -0.5)
        r[np.isinf(r)] = 0.0
        rp = np.zeros((n_pad, 1), np.float32)
        rp[:n, 0] = r
        g.r = torch.from_numpy(rp).to(dev)
    else:
        g.edge = edge_values_coo(anorm, g.ind_bsr)
    return g


def _make_spmm(graph: LargeGraph) -> Callable[[torch.Tensor], torch.Tensor]:
    """y -> Anorm @ y on [n_pad, F]."""
    ind = graph.ind_bsr
    if graph.use_bsr and graph.edge is not None:
        # Anorm's values, one per set bit of the structure blocks
        def anorm_spmm(y):
            return edge_spmm_rows(graph.edge, graph.ind_row_ptr,
                                  ind.blk_cols, y, ind.n_rows,
                                  ind.block_size)
        return anorm_spmm
    if graph.use_bsr:
        # separable: Anorm @ y = r * (A @ (r * y)) over the structure blocks
        def anorm_spmm(y):
            return bsr_spmm_rows(ind, y * graph.r, graph.ind_row_ptr) \
                * graph.r
        return anorm_spmm

    def anorm_spmm(y):
        return ell_spmm(graph.ell_cols, graph.ell_vals, y)
    return anorm_spmm


@torch.no_grad()
def large_gcn_forward(graph: LargeGraph, params_list, x: torch.Tensor,
                      hidden_act=leaky_relu02, final_act=identity,
                      max_degree: int = 1,
                      fused: Optional[bool] = None) -> torch.Tensor:
    """L-layer ChebGCN forward on a large graph (gcn/layers.py:199-208 per
    layer), every support application through the sparse route.

    params_list: [{'w_0': [Fin, Fout], 'w_1': ..., optional 'bias'}] per
    layer on the graph's device (`params_to_list`). x: [n_pad, F] f32.

    Separable graphs on the BSR route with K=1 take the fused layer kernel
    (bf16 activations, f32 W-products). ``fused=False`` (or
    DISTGCN_LARGE_EXACT=1) takes the f32 route: full-f32 matmuls and the
    SpMM.
    """
    if fused is None:
        fused = (graph.use_bsr and graph.separable and max_degree == 1
                 and hidden_act is leaky_relu02
                 and (final_act is identity or final_act is leaky_relu02)
                 and os.environ.get("DISTGCN_LARGE_EXACT", "0") != "1")
    if fused:
        ind = graph.ind_bsr
        layers = (params_list.fused() if isinstance(params_list, LayerParams)
                  else pad_params(params_list))
        out = fused_forward(
            ind.blk_vals, graph.ind_row_ptr, ind.blk_cols, graph.r, layers,
            x, ind.n_rows, ind.block_size,
            final_act_mode=1 if final_act is leaky_relu02 else 0,
            bitmap=graph.bitmap)
        return out[:, : params_list[-1]["w_0"].shape[1]]
    anorm_spmm = _make_spmm(graph)
    h = x
    nl = len(params_list)
    for li, layer in enumerate(params_list):
        out = h @ layer["w_0"]                               # S0 = I
        for k in range(1, max_degree + 1):
            y = h @ layer[f"w_{k}"]
            for _ in range(k):                               # L^k @ y
                y = y - anorm_spmm(y)
            out = out + y
        if "bias" in layer:
            out = out + layer["bias"]
        h = hidden_act(out) if li < nl - 1 else final_act(out)
    return h


LGS_RING = 32        # slots of a graph's ring of per-round counts
LGS_FIRST = 4        # the first batch of a graph's first solve


@dataclass
class LgsState:
    """A graph's `bsr_lgs` state on one device, kept between its solves.

    ``counts`` (int32 [1 + LGS_RING]): slot 0 holds 1, the open count that
    lets the first round run; round r counts the nodes it leaves undecided
    into slot 1 + r % LGS_RING. ``key``, ``win`` and ``sel`` ([n_pad] f32,
    f32, int8): the rounds' state, which ``passes`` (the round's two
    passes, `ops.spmm.lgs_round_passes`) are bound to, with ``stream`` the
    CUDA stream they launch on (None on the CPU). ``rounds``: the last
    solve's rounds (None before the first), which sizes the next solve's
    first batch. ``desc``: n, n - 1, ..., 1 in f32, the ranks in
    `lgs_order`'s order, for n weights; ``decided``: -1.0, the key of a
    node out of the mask."""
    counts: torch.Tensor
    key: torch.Tensor
    win: torch.Tensor
    sel: torch.Tensor
    decided: torch.Tensor
    passes: tuple = ()
    stream: Optional[torch.cuda.Stream] = None
    rounds: Optional[int] = None
    desc: Optional[torch.Tensor] = None


def _lgs_state(graph: LargeGraph, device: torch.device) -> LgsState:
    """The graph's `bsr_lgs` state on `device`, made at its first solve
    there. Its passes are bound again when the current CUDA stream is
    another one, which first waits for the last."""
    state, ind = graph.lgs_state, graph.ind_bsr
    if state is None or state.counts.device != device:
        rows = ind.n_rows
        state = graph.lgs_state = LgsState(
            counts=torch.tensor([1] + [0] * LGS_RING, dtype=torch.int32,
                                device=device),
            key=torch.full((rows,), -1.0, device=device),
            win=torch.zeros(rows, device=device),
            sel=torch.zeros(rows, dtype=torch.int8, device=device),
            decided=torch.tensor(-1.0, device=device))
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    if not state.passes or stream != state.stream:
        if stream is not None and state.stream is not None:
            stream.wait_stream(state.stream)
        state.passes = lgs_round_passes(
            ind.blk_vals, graph.ind_row_ptr, ind.blk_cols, state.key,
            state.win, state.sel, state.counts, ind.n_rows, ind.block_size,
            graph.bitmap)
        state.stream = stream
    return state


def lgs_batches(first: int, cap: int):
    """The sizes of a solve's batches of rounds: ``first``, then 2, 4, 8,
    ..., each cut to the rounds left under ``cap`` and to LGS_RING - 1
    (a batch never overwrites the count that gates its first round)."""
    done, size = 0, first
    while done < cap:
        k = min(size, cap - done, LGS_RING - 1)
        yield k
        done += k
        size = 2 if done == k else 2 * size


@torch.no_grad()
def bsr_lgs(graph: LargeGraph, wts: torch.Tensor, mask: torch.Tensor,
            max_rounds: Optional[int] = None):
    """LGS over a large graph with block-sparse neighbour reductions.

    Same rank-based rounds as `ops.lgs` (heuristics.py:77-116, the
    :106-111 tie-break folded into the ranks). A round is two passes over
    the graph's structure blocks, each a neighbour-max with the round's
    logic after it (`ops.spmm.lgs_round_passes`: the remaining-rank max
    and the winners, then the winner spread, the selections and the
    round's count of nodes left). A node's key is its rank while
    undecided and -1 once decided; ranks ride in f32, exact below 2^24
    nodes.

    The host enqueues the rounds in batches (`lgs_batches`: the first
    holds the graph's last solve's rounds plus one, LGS_FIRST on its first
    solve) and reads the batch's counts once after it. The solve's rounds
    are 1 + the index of the first zero count. A round after that finds
    the previous count 0 and is gated (a launch each pass, no walk), so
    sel, util and rounds are those of one read a round, and no round past
    ``max_rounds`` is enqueued. When `mask` is the graph's own, the first
    batch starts without a read. The rounds' state and their bound passes
    are the graph's (`LgsState`), kept for its next solve. Returns (sel
    [n_pad] int8, util, rounds).

    Counters: ``bsr_lgs.reads`` (host reads of the counts),
    ``bsr_lgs.rounds_enqueued`` (rounds launched, gated or not) and
    ``bsr_lgs.rounds`` (rounds that did work).
    """
    ind = graph.ind_bsr
    n = wts.shape[0]
    if ind.n_rows >= 1 << 24:
        # integers above 2^24 are not exact in f32: tied ranks would stall
        raise ValueError(f"n_pad={ind.n_rows} >= 2^24: LGS ranks lose "
                         "exactness in f32 — partition the solve")
    state = _lgs_state(graph, wts.device)
    if state.desc is None or state.desc.shape[0] != n:
        state.desc = torch.arange(n, 0, -1, dtype=torch.float32,
                                  device=wts.device)
    # key: the ranks (`lgs_ranks`) where the mask is set, -1 elsewhere;
    # sel: -1 (undecided) where it is set, 0 elsewhere
    ranks = torch.empty_like(state.desc).scatter_(0, lgs_order(wts),
                                                  state.desc)
    torch.where(mask, ranks, state.decided, out=state.key[:n])
    torch.mul(mask, -1, out=state.sel[:n])
    if n < ind.n_rows:
        state.key[n:] = -1.0
        state.sel[n:] = 0
    rank_pass, spread_pass = state.passes
    cap = n if max_rounds is None else int(max_rounds)
    if mask is graph.mask:
        left = graph.n > 0
    else:
        with span("distgcn.sync"):      # the host waits for the device
            left = bool(mask.any())
    first = LGS_FIRST if state.rounds is None else state.rounds + 1
    r, prev = 0, 0
    batches = lgs_batches(first, cap) if left else ()
    for k in batches:
        for _ in range(k):
            cur = 1 + r % LGS_RING
            rank_pass(prev, cur)
            spread_pass(prev, cur)
            prev, r = cur, r + 1
        _COUNTERS.rounds_enqueued += k
        _COUNTERS.reads += 1
        with span("distgcn.sync"):      # one read of the batch's counts
            counts = state.counts.tolist()
        done = next((j + 1 for j in range(r - k, r)
                     if counts[1 + j % LGS_RING] == 0), None)
        if done is not None:
            r = done
            break
    state.rounds = r
    _COUNTERS.rounds += r
    sel = state.sel[:n].clone()
    util = torch.where(sel == 1, wts, 0.0).sum()
    return sel, util, torch.full((), r, dtype=torch.int32, device=wts.device)


# the counters sit on the function, reached by this name so that they stay
# reachable where a caller replaces `large.bsr_lgs` by a wrapper of it
_COUNTERS = bsr_lgs
bsr_lgs.reads = bsr_lgs.rounds_enqueued = bsr_lgs.rounds = 0


class LayerParams(list):
    """`params_to_list`'s per-layer parameter dicts. Also holds the fused
    kernel's padded copy of them (`ops.cheb_fused.pad_params`), made at
    the first fused forward and made again only after a tensor of the list
    was replaced or changed in place."""

    def fused(self) -> list:
        tensors = [t for layer in self for t in layer.values()]
        stamp = [(id(t), t._version) for t in tensors]
        if getattr(self, "_stamp", None) != stamp:
            # the references keep the ids of the stamp from being reused
            self._padded, self._stamp, self._refs = (pad_params(self), stamp,
                                                     tensors)
        return self._padded


def params_to_list(params: Mapping, device=None) -> LayerParams:
    """ChebGCN parameter tree {'gc1': {'w_0', 'w_1'[, 'bias']}, ...} of
    array-likes (`utils.serialization.load_params`, or a JAX tree turned
    into numpy) -> ordered per-layer list of f32 tensors on `device`."""
    dev = resolve_device(device)

    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to(dev, torch.float32, copy=True)
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)

    n = sum(1 for k in params if k.startswith("gc"))
    return LayerParams({name: leaf(v) for name, v in params[f"gc{i + 1}"]
                        .items()} for i in range(n))


def _features(graph: LargeGraph, wts, m, feature_size: int, predict: str):
    if predict == "mwis":
        return torch.full((graph.n_pad, feature_size), 1.0 / feature_size,
                          dtype=torch.float32, device=m.device) * m[:, None]
    norm = (wts.abs() * m).max() + 1e-9
    return (wts / norm)[:, None].repeat(1, feature_size) * m[:, None]


def _lgs(graph: LargeGraph):
    if graph.use_bsr:
        return lambda w: bsr_lgs(graph, w, graph.mask)
    return lambda w: ell_lgs(graph.ell_cols, graph.ell_valid, w, graph.mask)


def make_large_solve(graph: LargeGraph, feature_size: int = 1,
                     max_degree: int = 1, predict: str = "mwis",
                     final_act_same: bool = False,
                     with_baseline: bool = False):
    """End-to-end solve(params_list, wts) on one large graph; wts is
    [n_pad] f32 on the graph's device.

    Returns (sel [n_pad] int8, util, greedy-baseline util or 0) — the
    large-N analog of `pipeline.make_solve_pipeline`.
    """
    final_act = leaky_relu02 if final_act_same else identity
    lgs = _lgs(graph)

    @torch.no_grad()
    def solve(params_list, wts):
        m = graph.mask.to(wts.dtype)
        feats = _features(graph, wts, m, feature_size, predict)
        out = large_gcn_forward(graph, params_list, feats,
                                final_act=final_act, max_degree=max_degree)
        act = out[:, 0] * m
        gcn_wts = act * wts if predict == "mwis" else act
        sel = lgs(gcn_wts)[0]
        util = torch.where(sel == 1, wts, torch.zeros_like(wts)).sum()
        if not with_baseline:
            return sel, util, torch.zeros_like(util)
        return sel, util, lgs(wts * m)[1]

    return solve


def make_large_closed_loop(graph: LargeGraph, timeslots: int,
                           load: float = 0.9, rate_lo: float = 0.0,
                           rate_hi: float = 100.0, wt_sel: str = "qr",
                           feature_size: int = 1, max_degree: int = 1,
                           predict: str = "mwis",
                           feature_mode: str = "gdpg"):
    """City-scale closed-loop scheduling: a T-slot episode on ONE large
    conflict graph (the large-N analog of `sim.device_sim.make_closed_loop`).

    Per slot: Poisson arrivals, truncated-Gaussian link rates, `wt_sel`
    utilities, GCN scoring, LGS, queue departures; the graph stays on the
    device. With predict='mwis' and feature_mode != 'dqn' the features do
    not depend on the weights, so the GCN runs once per episode.

    Returns run(params_list, queue0, generator) ->
      (queueT [n_pad], {"avg_queue_len", "avg_utility", "sched_rate"});
    the generator lies on the graph's device. Episodes agree with the JAX
    package in distribution, not draw for draw.
    """
    draw_arrivals = make_poisson_arrivals(0.5 * (rate_lo + rate_hi) * load)
    mean_r = 0.5 * (rate_lo + rate_hi)
    std_r = 0.25 * (rate_hi - rate_lo)
    hoist_gcn = predict == "mwis" and feature_mode != "dqn"
    lgs = _lgs(graph)

    @torch.no_grad()
    def run(params_list, queue0, generator: torch.Generator):
        dev = queue0.device
        m = graph.mask.to(torch.float32)

        def scores(feats):
            out = large_gcn_forward(graph, params_list, feats,
                                    max_degree=max_degree)
            return out[:, 0] * m

        if hoist_gcn:
            with span("distgcn.gcn"):
                act_h = scores(_features(graph, None, m, feature_size,
                                         predict))
        stats = torch.empty((timeslots, 3), dtype=torch.float32, device=dev)
        queue = queue0
        for t in range(timeslots):
            with span("distgcn.slot"):
                arrivals = draw_arrivals(generator, queue.shape,
                                         queue.dtype) * m
                rates = torch.randn(queue.shape, generator=generator,
                                    device=dev) * std_r + mean_r
                rates = torch.clamp(torch.trunc(rates), rate_lo,
                                    rate_hi) * m
                queue = queue + arrivals
                wts = slot_utilities(queue[None], rates[None], wt_sel,
                                     generator)[0] * m
                if hoist_gcn:
                    act = act_h
                else:
                    with span("distgcn.gcn"):
                        feats = _features(graph, wts, m, feature_size,
                                          predict)
                        if predict == "mwis":
                            feats = feats * (wts != 0).to(
                                torch.float32)[:, None]
                        act = scores(feats)
                gcn_wts = act * wts if predict == "mwis" else act
                with span("distgcn.lgs"):
                    sel = lgs(gcn_wts)[0]
                on = (sel == 1).to(queue.dtype)
                queue = queue - torch.minimum(queue, rates * on)
                stats[t, 0] = (queue * m).sum()
                stats[t, 1] = torch.where(sel == 1, wts,
                                          torch.zeros_like(wts)).sum()
                stats[t, 2] = on.sum()
        nreal = torch.clamp(m.sum(), min=1.0)
        metrics = {"avg_queue_len": stats[:, 0].mean() / nreal,
                   "avg_utility": stats[:, 1].mean(),
                   "sched_rate": stats[:, 2].mean() / nreal}
        return queue, metrics

    return run


def serpentine_order(xy: np.ndarray, tile: int = 256) -> np.ndarray:
    """Boustrophedon tile ordering for coordinate graphs: nodes cut into
    equal-count horizontal bands (by y rank), each band sorted by x in
    alternating direction, so consecutive ranges of `tile` nodes are
    compact spatial tiles and a tile's conflicts sit in a bounded window
    of block-columns. Returns the permutation (new index -> old index)."""
    n = xy.shape[0]
    g = max(int(round(np.sqrt(max(n // tile, 1)))), 1)
    yrank = np.empty(n, np.int64)
    yrank[np.argsort(xy[:, 1], kind="stable")] = np.arange(n)
    band = np.minimum(yrank * g // n, g - 1)
    x = xy[:, 0].copy()
    flip = band % 2 == 1
    x[flip] = -x[flip]                     # serpentine: odd bands reversed
    return np.lexsort((x, band))


def geometric_conflict_graph(n: int, avg_degree: float = 24.0,
                             seed: int = 0, weight_dist: str = "uniform",
                             order: str = "rcm"):
    """Synthetic city-scale conflict graph with locality ordering.

    Links dropped uniformly in the unit square conflict when closer than
    the radius giving the target average degree. Nodes are reordered by
    order='rcm' (reverse Cuthill-McKee), 'grid' (`serpentine_order`) or
    'morton' (space-filling key). Returns (adj csr, wts, xy); the same
    seed gives the JAX package's graph.
    """
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2))
    r = np.sqrt((avg_degree + 1) / (np.pi * n))
    from scipy.spatial import cKDTree
    tree = cKDTree(xy)
    pairs = tree.query_pairs(r, output_type="ndarray")
    data = np.ones(len(pairs), np.float32)
    adj = sp.coo_matrix((data, (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    adj = (adj + adj.T).tocsr()
    if order == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        perm = reverse_cuthill_mckee(adj, symmetric_mode=True)
    elif order == "grid":
        perm = serpentine_order(xy, tile=256)
    else:  # morton
        gx = np.minimum((xy[:, 0] * 1024).astype(np.int64), 1023)
        gy = np.minimum((xy[:, 1] * 1024).astype(np.int64), 1023)

        def _spread(v):
            v = (v | (v << 16)) & 0x0000FFFF0000FFFF
            v = (v | (v << 8)) & 0x00FF00FF00FF00FF
            v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
            v = (v | (v << 2)) & 0x3333333333333333
            v = (v | (v << 1)) & 0x5555555555555555
            return v

        perm = np.argsort(_spread(gx) | (_spread(gy) << 1), kind="stable")
    adj = adj[perm][:, perm].tocsr()
    xy = xy[perm]
    if weight_dist == "uniform":
        wts = rng.random(n).astype(np.float32)
    else:
        wts = np.abs(rng.normal(size=n)).astype(np.float32)
    return adj, wts, xy
