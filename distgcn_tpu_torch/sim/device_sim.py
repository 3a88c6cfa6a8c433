"""Device-resident closed-loop wireless scheduler and online trainer.

Port of `distgcn_tpu/sim/device_sim.py` (`make_slot_step`,
`make_closed_loop` with its data-sharded mode, the multi-channel
`make_closed_loop_mc` and `make_closed_loop_seq`,
`make_online_training_loop`). The conflict graphs, GCN
parameters, supports, queues and the traffic RNG all live on the device; the
T-slot episode is a Python loop that never synchronises with the host (the
LGS kernel launches without a sync and per-slot metrics stay on the device
until the end).

Semantics per slot (the reference's wireless_dqn_test.py):
- arrivals ~ Poisson(0.5*(rate_lo+rate_hi)*load) per link;
- link rates = truncated-Gaussian integers in [rate_lo, rate_hi];
- utilities per `wt_sel` in {qr, q, qor, qrm, random};
- schedule = GCN-reweighted LGS (DGCN-LGS) or plain LGS;
- queue += arrivals; departures = min(queue, rate * scheduled);
  queue -= departures.

The episode draws from a `torch.Generator` on the device; its streams
cannot match `jax.random`'s, so episodes agree with the JAX package in
distribution, not draw for draw. `make_slot_step` takes arrivals and rates
as inputs and is exact against the JAX step. The JAX module's
`_features_for` repeats `agents.build_features`; here the slot calls that
function itself.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from distgcn_tpu_torch.agents import build_features
from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.models.gcn import cast_model
from distgcn_tpu_torch.ops.lgs import batched_lgs
from distgcn_tpu_torch.parallel.distributed import gather_global
from distgcn_tpu_torch.parallel.mesh import batch_sharding
from distgcn_tpu_torch.pipeline import (_compute_dtype, gcn_weights,
                                        selected_utility)
from distgcn_tpu_torch.rl.train import apply_updates, first_layer_l2
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.profiling import span


def _poisson_cdf(lam: float, tail: float = 1e-9) -> np.ndarray:
    """Poisson(lam) CDF table up to the (1-tail) quantile (float64 host).

    Raises ValueError once exp(-lam) leaves the normal float64 range
    (lam > ~708): the recurrence starts from it, and the table would
    silently degenerate there.
    """
    if lam <= 0:
        return np.ones(1)
    p0 = np.exp(-lam)
    if p0 < np.finfo(np.float64).tiny:
        raise ValueError(
            f"Poisson arrival rate {lam} is too large for the inverse-CDF "
            "table: exp(-lam) underflows float64 above lam ~708")
    pmf = [p0]
    while sum(pmf) < 1.0 - tail and len(pmf) < int(8 * lam + 64):
        pmf.append(pmf[-1] * lam / len(pmf))
    return np.cumsum(pmf)


def make_poisson_arrivals(lam: float):
    """Exact static-rate Poisson sampler: inverse CDF from ONE uniform.

    Returns draw(generator, shape, dtype) -> counts on the generator's
    device: ``#{k : u > cdf[k]}`` over a float32 cdf, i.e. the number of
    entries strictly less than u (`torch.searchsorted` on the left side).
    """
    cdf32 = torch.from_numpy(_poisson_cdf(lam).astype(np.float32))
    per_device = {}

    def draw(generator: torch.Generator, shape, dtype=torch.float32):
        dev = generator.device
        cdf = per_device.get(dev)
        if cdf is None:
            cdf = per_device[dev] = cdf32.to(dev)
        u = torch.rand(shape, generator=generator, device=dev)
        return torch.searchsorted(cdf, u).to(dtype)

    return draw


def slot_utilities(queue: torch.Tensor, rates: torch.Tensor, wt_sel: str,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Per-slot utilities (wireless_dqn_test.py:219-230) in the broadcast
    shape of `queue` and `rates`: [B, N], or [B, Nf, n_ch] for per-link
    queues [B, Nf, 1] against per-channel rates."""
    queue = queue.expand(torch.broadcast_shapes(queue.shape, rates.shape))
    if wt_sel == "qr":
        return queue * rates
    if wt_sel == "q":
        return queue
    if wt_sel == "qor":
        return torch.where(rates > 0, queue / torch.clamp(rates, min=1e-9),
                           torch.zeros_like(queue))
    if wt_sel == "qrm":
        return torch.minimum(queue, rates)
    if wt_sel == "random":
        if generator is None:
            raise ValueError("wt_sel='random' needs a torch.Generator")
        return torch.rand(queue.shape, generator=generator,
                          device=queue.device)
    raise ValueError(f"unsupported wt_sel {wt_sel}")


def _traffic(load: float, rate_lo: float, rate_hi: float) -> Callable:
    """draw(generator, m, n_ch=None) -> (arrivals [B,N], rates): one slot's
    Poisson arrivals and truncated-Gaussian integer rates (trunc toward
    zero, then clamp), zero where the float mask `m` is 0. Rates are [B,N],
    or [B,N,n_ch] per channel. Arrivals are drawn first, then rates."""
    draw_arrivals = make_poisson_arrivals(0.5 * (rate_lo + rate_hi) * load)
    mean_r = 0.5 * (rate_lo + rate_hi)
    std_r = 0.25 * (rate_hi - rate_lo)

    def draw(generator: torch.Generator, m: torch.Tensor,
             n_ch: Optional[int] = None):
        arrivals = draw_arrivals(generator, m.shape, m.dtype) * m
        shape, mr = (m.shape, m) if n_ch is None else \
            ((*m.shape, n_ch), m[..., None])
        rates = torch.randn(shape, generator=generator,
                            device=m.device) * std_r + mean_r
        return arrivals, torch.clamp(torch.trunc(rates), rate_lo,
                                     rate_hi) * mr

    return draw


def _check_generator(generator: torch.Generator, dev: torch.device) -> None:
    if _index(generator.device) != _index(dev):
        raise ValueError(f"generator on {generator.device}, inputs on {dev}")


def _gcn_scorer(model, flags: Config, feature_mode: str) -> Callable:
    """scores(supports, wts, mask) -> LGS weights, running the GCN on
    features in the supports' dtype."""
    def scores(supports, wts, mask):
        feats = build_features(wts, mask, flags.feature_size, flags.predict,
                               feature_mode)
        return gcn_weights(model, feats.to(supports.dtype), supports, wts,
                           mask, flags.predict)
    return scores


def _episode_scorer(model, flags: Config, feature_mode: str, adj, mask):
    """(supports, scores) for one episode on a static graph: the masked
    supports and the model cast once to the episode dtype
    (``flags.compute_dtype``). With ``feature_mode='gdpg'`` and
    ``predict='mwis'`` the features do not depend on the weights, so the
    GCN runs here once and `scores` only multiplies (XLA hoists the same
    computation out of the JAX scan); otherwise it runs every call."""
    dtype = _compute_dtype(flags)
    supports = prep.masked_simple_polynomials_dense(
        adj, mask, flags.max_degree).to(dtype)
    scores = _gcn_scorer(cast_model(model, dtype), flags, feature_mode)
    if flags.predict == "mwis" and feature_mode == "gdpg":
        with span("distgcn.gcn"):
            act = scores(supports, torch.ones(mask.shape, device=mask.device),
                         mask)
        return supports, lambda supports, wts, mask: act * wts
    return supports, scores


def _slot(scores: Optional[Callable], wt_sel: str, supports, adjb, mask,
          queue, arrivals, rates):
    queue = queue + arrivals
    wts = slot_utilities(queue, rates, wt_sel) * mask
    gcn_wts = wts
    if scores is not None:
        with span("distgcn.gcn"):
            gcn_wts = scores(supports, wts, mask)
    with span("distgcn.lgs"):
        sel = batched_lgs(adjb, gcn_wts, mask)[0]
    on = (sel == 1).to(queue.dtype)
    departures = torch.minimum(queue, rates * on)
    queue = queue - departures
    return queue, sel, selected_utility(sel, wts), wts


def make_slot_step(model, flags: Config, feature_mode: str = "gdpg",
                   wt_sel: str = "qr", use_gcn: bool = True):
    """Deterministic one-slot step for parity tests.

    Returns step(supports, adjb, mask, queue, arrivals, rates) ->
    (queue', sel [B,N] int8, util [B], wts [B,N] scheduling-time
    utilities). The model's params must be in the supports' dtype.
    """
    scores = _gcn_scorer(model, flags, feature_mode) if use_gcn else None

    @torch.no_grad()
    def step(supports, adjb, mask, queue, arrivals, rates):
        return _slot(scores, wt_sel, supports, adjb, mask, queue, arrivals,
                     rates)

    return step


def _index(dev: torch.device) -> torch.device:
    """`dev` with its index (a CUDA generator reports plain 'cuda')."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_closed_loop(model, flags: Config, timeslots: int,
                     load: float = 0.9, rate_lo: float = 0.0,
                     rate_hi: float = 100.0, wt_sel: str = "qr",
                     feature_mode: str = "gdpg", use_gcn: bool = True,
                     with_baseline: bool = False, mesh=None):
    """Closed-loop T-slot scheduling episode.

    Returns run(adj, mask, queue0, generator) ->
      (queueT [B,N],
       {"avg_queue_len": [B], "avg_utility": [B], "sched_rate": [B]}
       plus "avg_utility_ratio": [B] if with_baseline)

    adj is the dense [B,N,N] 0/1 conflict adjacency (static over the
    episode); supports are built once per episode and stay resident. The
    generator lies on the device of the other inputs. In bf16 episodes
    (``flags.compute_dtype``) the supports and params are cast once per
    episode and the features follow the supports' dtype.

    With ``feature_mode='gdpg'`` and ``predict='mwis'`` the GCN features
    do not depend on the weights, so the scores are computed once per
    episode (XLA hoists the same computation out of the JAX scan); every
    other mode runs the GCN every slot.

    mesh: an optional `parallel.mesh.Mesh`, which shards the graph batch
    over its data axis (the JAX loop's ``P('data')``; the model and the
    generator replicated). Every rank of the mesh passes the whole batch,
    B a multiple of ``mesh.n_data``, on its own device, with a generator
    that every rank seeds alike. Each slot draws the whole batch's
    arrivals and rates, so a rank's rows see the unsharded episode's draws,
    and the rank schedules only its rows (`batch_sharding`; the ranks of
    the model axis repeat them), with no collective inside the T slots.
    One all-gather over the data axis at the end, of the final queues and
    the per-slot stats, gives every rank the whole batch's result. It is
    the unsharded episode's bit for bit as long as each graph's GCN, B1
    launch and sums over its own nodes come out alike at B/n_data graphs
    and at B (a GEMM that sums in another order for fewer graphs would
    break that).
    """
    traffic = _traffic(load, rate_lo, rate_hi)
    rows = (lambda b: slice(None)) if mesh is None else batch_sharding(mesh)
    gather = mesh is not None and mesh.n_data > 1

    def episode(adj, mask, queue0, generator):
        dev = queue0.device
        _check_generator(generator, dev)
        m_all = mask.to(queue0.dtype)
        sl = rows(queue0.shape[0])
        adj, mask, queue0, m = adj[sl], mask[sl], queue0[sl], m_all[sl]
        adjb = adj > 0
        supports, scores = None, None
        if use_gcn:
            supports, scores = _episode_scorer(model, flags, feature_mode,
                                               adj, mask)
        n_stats = 4 if with_baseline else 3
        stats = torch.empty((timeslots, n_stats, queue0.shape[0]),
                            dtype=torch.float32, device=dev)
        queue = queue0
        for t in range(timeslots):
            with span("distgcn.slot"):
                arrivals, rates = traffic(generator, m_all)
                arrivals, rates = arrivals[sl], rates[sl]
                queue, sel, util, wts = _slot(scores, wt_sel, supports,
                                              adjb, mask, queue, arrivals,
                                              rates)
                stats[t, 0] = (queue * m).sum(dim=-1)
                stats[t, 1] = util
                stats[t, 2] = (sel == 1).to(torch.float32).sum(dim=-1)
                if with_baseline:
                    with span("distgcn.lgs"):
                        stats[t, 3] = batched_lgs(adjb, wts, mask)[1]
        if gather:
            queue, stats = _gather_rows(queue, stats, mesh.data_group)
        nreal = torch.clamp(m_all.sum(dim=-1), min=1.0)
        metrics = {
            "avg_queue_len": stats[:, 0].mean(dim=0) / nreal,
            "avg_utility": stats[:, 1].mean(dim=0),
            "sched_rate": stats[:, 2].mean(dim=0) / nreal,
        }
        if with_baseline:
            metrics["avg_utility_ratio"] = (
                stats[:, 1] / torch.clamp(stats[:, 3], min=1e-9)).mean(dim=0)
        return queue, metrics

    @torch.no_grad()
    def run(adj, mask, queue0, generator: torch.Generator):
        with span("distgcn.episode"):
            return episode(adj, mask, queue0, generator)

    return run


def _gather_rows(queue, stats, group):
    """Every data rank's rows of the final queues [b, N] and of the per-slot
    stats [T, k, b], packed into one [b, N + T*k] slab and all-gathered
    over `group`: ([B, N], [T, k, B]), the stats contiguous as the
    unsharded episode holds them. The metrics are then reduced over the
    whole batch's stats as the unsharded episode reduces them: a mean over
    T may sum in another order for fewer columns or another layout."""
    t, k, b = stats.shape
    n = queue.shape[1]
    slab = gather_global(torch.cat([queue, stats.reshape(t * k, b).T],
                                   dim=1), group)
    return (slab[:, :n].to(queue.dtype),
            slab[:, n:].T.reshape(t, k, -1).to(stats.dtype).contiguous())


def make_closed_loop_mc(model, flags: Config, timeslots: int, n_ch: int,
                        load: float = 0.9, rate_lo: float = 0.0,
                        rate_hi: float = 100.0, wt_sel: str = "qr",
                        feature_mode: str = "gdpg", use_gcn: bool = True):
    """Multi-channel closed loop on the product conflict graph.

    One node per (link, channel), per-channel conflict edges plus a
    single-radio clique across a link's channel copies
    (wireless_rollout_test_flood.py:98-133); flat node id = ch*nflows+link
    (order='F', wireless_dqn_test_mc.py:229; `data.wireless.
    pad_product_graph` for padded batches). Queues are per LINK; a scheduled
    (link, ch) drains at that channel's rate (the clique allows at most one
    channel per link). One LGS launch a slot. Supports, GCN hoist and bf16
    casts as in `make_closed_loop`; the link mask is tiled over the
    channels, so a padded product node can neither enter a schedule nor
    block one. Spans as in `make_closed_loop`: ``distgcn.episode`` around
    a run, ``distgcn.slot`` around each slot, ``distgcn.gcn`` and
    ``distgcn.lgs`` inside it.

    Returns run(adj_gk, link_mask, queue0, generator) ->
      (queueT [B,Nf], {"avg_queue_len": [B], "avg_utility": [B],
                       "sched_rate": [B]})
    with adj_gk [B, n_ch*Nf, n_ch*Nf] and link_mask [B, Nf].
    """
    traffic = _traffic(load, rate_lo, rate_hi)

    def episode(adj_gk, link_mask, queue0, generator):
        dev = queue0.device
        _check_generator(generator, dev)
        b, nf = queue0.shape
        nk = adj_gk.shape[-1]
        if nk != n_ch * nf:
            raise ValueError(f"product graph of {nk} nodes for {n_ch} "
                             f"channels x {nf} links")
        m = link_mask.to(queue0.dtype)
        mask_k = link_mask.tile(1, n_ch)                    # [B, nch*Nf]
        adjb = adj_gk > 0
        supports, scores = None, None
        if use_gcn:
            supports, scores = _episode_scorer(model, flags, feature_mode,
                                               adj_gk, mask_k)
        stats = torch.empty((timeslots, 3, b), dtype=torch.float32,
                            device=dev)
        queue = queue0
        for t in range(timeslots):
            with span("distgcn.slot"):
                arrivals, rates = traffic(generator, m, n_ch)  # [B,Nf,C]
                queue = queue + arrivals
                wts3 = slot_utilities(queue[:, :, None], rates, wt_sel,
                                      generator)
                # order='F' flatten: node ch*nflows+link
                wts = wts3.transpose(1, 2).reshape(b, nk) * mask_k
                gcn_wts = wts
                if scores is not None:
                    with span("distgcn.gcn"):
                        gcn_wts = scores(supports, wts, mask_k)
                with span("distgcn.lgs"):
                    sel = batched_lgs(adjb, gcn_wts, mask_k)[0]
                on3 = (sel == 1).reshape(b, n_ch, nf).to(queue.dtype)
                capacity = (rates.transpose(1, 2) * on3).sum(dim=1)
                queue = queue - torch.minimum(queue, capacity)
                stats[t, 0] = (queue * m).sum(dim=-1)
                stats[t, 1] = selected_utility(sel, wts)
                stats[t, 2] = (sel == 1).to(torch.float32).sum(dim=-1)
        nreal = torch.clamp(m.sum(dim=-1), min=1.0)
        return queue, {
            "avg_queue_len": stats[:, 0].mean(dim=0) / nreal,
            "avg_utility": stats[:, 1].mean(dim=0),
            "sched_rate": stats[:, 2].mean(dim=0) / nreal,
        }

    @torch.no_grad()
    def run(adj_gk, link_mask, queue0, generator: torch.Generator):
        with span("distgcn.episode"):
            return episode(adj_gk, link_mask, queue0, generator)

    return run


def make_online_train_step(model, flags: Config, optimizer,
                           wt_sel: str = "qr", feature_mode: str = "gdpg"):
    """One slot of online RL training, with arrivals and rates as inputs.

    The slot schedules with the CURRENT parameters, computes the reward
    ``util / max(gutil, 1e-9)``, regresses head 0 of the model toward the
    DQN assignment target (target[solution] = reward, the other real nodes
    toward their own scores; mwis_dqn_call.py:168-171) with the RMSE over
    real nodes plus the layer-1 L2 term, and applies one `optimizer`
    update (a `rl.train.GradientTransformation`, e.g. `tf1_adam`) to the
    model's parameters in place — one gradient step per slot, batched over
    all B graphs. Two LGS launches per slot.

    As in the JAX package (`sim/device_sim.py:360-362`), ``util`` is the
    selected sum of the GCN weights ``act * w`` (`batched_lgs` returns the
    utility under the weights it is given) while ``gutil`` is under the raw
    weights, so the reward is sum(act*w)/sum_greedy(w), not the
    raw-utility ratio; ROADMAP §C records it. f32 only, like the JAX loop
    (``flags.compute_dtype`` is not read).

    Returns step(opt_state, supports, adjb, mask, queue, arrivals, rates)
    -> (opt_state, queue', {"loss": [], "ratio": [], "queue_sum": [B]}).
    """
    wd = flags.weight_decay
    params = dict(model.named_parameters())

    def step(opt_state, supports, adjb, mask, queue, arrivals, rates):
        m = mask.to(queue.dtype)
        queue = queue + arrivals
        wts = slot_utilities(queue, rates, wt_sel) * m
        feats = build_features(wts, mask, flags.feature_size, flags.predict,
                               feature_mode)
        out = model(feats, supports)                         # [B, N, D]
        act = out[..., 0].detach().to(wts.dtype) * m
        gcn_wts = act * wts if flags.predict == "mwis" else act
        sel, util, _ = batched_lgs(adjb, gcn_wts, mask)
        gutil = batched_lgs(adjb, wts, mask)[1]
        reward = util / torch.clamp(gutil, min=1e-9)          # [B]
        on = sel == 1
        labels = torch.where(on, reward[:, None], act)
        err = (out[..., 0] - labels) ** 2 * m
        mse = err.sum(dim=-1) / torch.clamp(m.sum(dim=-1), min=1.0)
        loss = torch.sqrt(mse).mean() + wd * first_layer_l2(model)
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, opt_state = optimizer.update(dict(zip(params, grads)),
                                              opt_state)
        apply_updates(params, updates)
        departures = torch.minimum(queue, rates * on.to(queue.dtype))
        queue = queue - departures
        return opt_state, queue, {"loss": loss.detach(),
                                  "ratio": reward.mean(),
                                  "queue_sum": (queue * m).sum(dim=-1)}

    return step


def make_online_training_loop(model, flags: Config, optimizer,
                              timeslots: int, load: float = 0.9,
                              rate_lo: float = 0.0, rate_hi: float = 100.0,
                              wt_sel: str = "qr",
                              feature_mode: str = "gdpg"):
    """Online RL training inside the scheduling episode, on the device.

    Every slot draws arrivals and rates (as `make_closed_loop` does) and
    runs `make_online_train_step`; the model's parameters are updated in
    place every slot, so no cast copy is kept.

    Returns run(opt_state, adj, mask, queue0, generator) ->
      (opt_state, queueT,
       {"loss": [T], "avg_utility_ratio": [T], "avg_queue_len": [B]}).
    """
    traffic = _traffic(load, rate_lo, rate_hi)
    step = make_online_train_step(model, flags, optimizer, wt_sel,
                                  feature_mode)

    def run(opt_state, adj, mask, queue0, generator: torch.Generator):
        dev = queue0.device
        _check_generator(generator, dev)
        m = mask.to(queue0.dtype)
        supports = prep.masked_simple_polynomials_dense(adj, mask,
                                                        flags.max_degree)
        adjb = adj > 0
        stats = torch.empty((timeslots, 2), dtype=torch.float32, device=dev)
        queue_sum = torch.empty((timeslots, queue0.shape[0]),
                                dtype=torch.float32, device=dev)
        queue = queue0
        for t in range(timeslots):
            arrivals, rates = traffic(generator, m)
            opt_state, queue, slot = step(opt_state, supports, adjb, mask,
                                          queue, arrivals, rates)
            stats[t, 0] = slot["loss"]
            stats[t, 1] = slot["ratio"]
            queue_sum[t] = slot["queue_sum"]
        nreal = torch.clamp(m.sum(dim=-1), min=1.0)
        return opt_state, queue, {
            "loss": stats[:, 0], "avg_utility_ratio": stats[:, 1],
            "avg_queue_len": queue_sum.mean(dim=0) / nreal}

    return run


def subgraph_supports(adj: torch.Tensor, keep: torch.Tensor, k: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """The supports of the subgraph on the nodes `keep` [B, N] bool of the
    dense adjacency `adj` [B, N, N], in `dtype`: the other nodes' rows and
    columns are zeroed, so the degrees, the normalisation and the identity
    cover the subgraph only. A node of the subgraph scores as it would in
    the graph with the other nodes deleted (and renumbered in order)."""
    m = keep.to(torch.float32)
    sub = adj.to(torch.float32) * m[..., :, None] * m[..., None, :]
    return prep.masked_simple_polynomials_dense(sub, keep, k).to(dtype)


def make_closed_loop_seq(model, flags: Config, timeslots: int, n_ch: int,
                         load: float = 0.9, rate_lo: float = 0.0,
                         rate_hi: float = 100.0, feature_mode: str = "gdpg",
                         use_gcn: bool = True):
    """Sequential multi-channel scheduling (LGS-Seq / DGCN-LGS-Seq) on the
    device — the reference's channel-by-channel algorithm with queue-drain
    estimates (wireless_dqn_test_mc.py:292-354, wt_sel='qr'):

    for each channel ic: utilities = q_est * rate_ic over that channel's own
    conflict graph; the links with zero utility are deleted, and the GCN
    scores the subgraph of the others (`subgraph_supports`, rebuilt every
    slot and channel: the host engine's ``solve_mwis`` on the deleted
    subgraph); LGS runs on that subgraph (a masked-out link can neither
    enter nor block); scheduled links' drain estimate min(q_est, rate_ic)
    carries to the next channel's utilities. A link scheduled on several
    channels departs the sum of their rates. One GCN forward and one LGS
    launch per channel: n_ch launches a slot. bf16 episodes cast the model
    once and build the supports in bf16.

    The JAX package's loop scores every channel on the whole channel graph
    (supports built once over the link mask), which differs from the
    subgraph's scores once a link's utility is 0 (ROADMAP §C, fault 8).

    Spans as in `make_closed_loop`: ``distgcn.episode``, ``distgcn.slot``,
    and in a slot ``distgcn.gcn`` (each channel's supports, features and
    forward) and ``distgcn.lgs`` (each channel's B1 launch).

    adj_ch: [B, n_ch, Nf, Nf] per-channel conflict adjacencies (static).
    Returns run(adj_ch, link_mask, queue0, generator) ->
      (queueT [B,Nf], {"avg_queue_len": [B], "avg_utility": [B]}).
    """
    traffic = _traffic(load, rate_lo, rate_hi)
    dtype = _compute_dtype(flags)

    def episode(adj_ch, link_mask, queue0, generator):
        dev = queue0.device
        _check_generator(generator, dev)
        b, _ = queue0.shape
        m = link_mask.to(queue0.dtype)
        adj_c = [adj_ch[:, ic].contiguous() for ic in range(n_ch)]
        adjb_c = [(a > 0) for a in adj_c]
        scores = None
        if use_gcn:
            scores = _gcn_scorer(cast_model(model, dtype), flags,
                                 feature_mode)
        stats = torch.empty((timeslots, 2, b), dtype=torch.float32,
                            device=dev)
        queue = queue0
        for t in range(timeslots):
            with span("distgcn.slot"):
                arrivals, rates = traffic(generator, m, n_ch)
                queue = queue + arrivals
                q_est = queue
                total_cap = torch.zeros_like(queue)
                util = torch.zeros((b,), dtype=queue.dtype, device=dev)
                for ic in range(n_ch):
                    rate_ic = rates[:, :, ic]
                    wts_ic = q_est * rate_ic                # qr utilities
                    mask_ic = link_mask & (wts_ic > 0)
                    gw = wts_ic
                    if scores is not None:
                        with span("distgcn.gcn"):
                            sup = subgraph_supports(adj_c[ic], mask_ic,
                                                    flags.max_degree, dtype)
                            gw = scores(sup, wts_ic, mask_ic)
                    with span("distgcn.lgs"):
                        sel = batched_lgs(adjb_c[ic], gw, mask_ic)[0]
                    on = (sel == 1).to(queue.dtype)
                    util = util + (wts_ic * on).sum(dim=-1)
                    total_cap = total_cap + rate_ic * on
                    q_est = q_est - torch.minimum(q_est, rate_ic) * on
                queue = queue - torch.minimum(queue, total_cap)
                stats[t, 0] = (queue * m).sum(dim=-1)
                stats[t, 1] = util
        nreal = torch.clamp(m.sum(dim=-1), min=1.0)
        return queue, {"avg_queue_len": stats[:, 0].mean(dim=0) / nreal,
                       "avg_utility": stats[:, 1].mean(dim=0)}

    @torch.no_grad()
    def run(adj_ch, link_mask, queue0, generator: torch.Generator):
        with span("distgcn.episode"):
            return episode(adj_ch, link_mask, queue0, generator)

    return run
