"""Batched device pipeline: state -> GCN -> LGS -> utility.

Port of `distgcn_tpu/pipeline.py` (`make_solve_pipeline`,
`make_train_pipeline`, `make_resident_pipeline`, `BatchedEvaluator`). A
batch of padded graphs goes through support construction, the GCN forward,
the LGS solve and the utility reduction with no host round-trip; on CUDA
tensors LGS is the hand-written kernel.

bf16 mode (``flags.compute_dtype == 'bfloat16'``) scores the GCN in bf16:
features, supports and params are cast; the solver-side weights stay f32,
so LGS tie-breaks and utilities are computed on f32 values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from distgcn_tpu_torch.agents import build_features, build_state_arrays
from distgcn_tpu_torch.core.graph import GraphBatch, pad_bucket
from distgcn_tpu_torch.models.gcn import cast_model
from distgcn_tpu_torch.ops.lgs import batched_lgs
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.device import resolve_device


def _compute_dtype(flags: Config) -> torch.dtype:
    return (torch.bfloat16 if flags.compute_dtype == "bfloat16"
            else torch.float32)


def gcn_weights(model, features, supports, wts, mask, predict: str):
    """Scores -> LGS weights: ``act * wts`` in 'mwis' mode, else ``act``,
    with ``act = out[..., 0]`` cast back to the weights' dtype."""
    out = model(features, supports)
    act = out[..., 0].to(wts.dtype) * mask
    return act * wts if predict == "mwis" else act


def selected_utility(sel: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    return torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(dim=-1)


def make_solve_pipeline(model, flags: Config, feature_mode: str = "gdpg",
                        with_baseline: bool = True):
    """Returns solve(adj, wts, mask) ->
    (sel [B,N] int8, util [B], greedy-baseline util [B]).

    with_baseline=False skips the second LGS sweep that computes the greedy
    baseline (gutil is zeros then).
    """
    dtype = _compute_dtype(flags)

    @torch.no_grad()
    def solve(adj, wts, mask):
        features, supports = build_state_arrays(
            adj, wts, mask, flags.feature_size, flags.max_degree,
            flags.predict, feature_mode)
        net = cast_model(model, dtype)
        gcn_wts = gcn_weights(net, features.to(dtype), supports.to(dtype),
                              wts, mask, flags.predict)
        sel = batched_lgs(adj, gcn_wts, mask)[0]
        util = selected_utility(sel, wts)
        if not with_baseline:
            return sel, util, torch.zeros_like(util)
        # greedy baseline on the same device pass (greedy == LGS on raw w)
        gutil = batched_lgs(adj, wts, mask)[1]
        return sel, util, gutil

    return solve


def make_train_pipeline(model, flags: Config, feature_mode: str = "gdpg"):
    """Training variant of `make_solve_pipeline` with the reference's
    epsilon-greedy VALUE exploration (mwis_gdpg_call.py:696-705: on an
    exploring graph the per-node scores are replaced by U(0,1) draws
    before the LGS; the memorized act_vals are those draws).

    Returns solve(adj, wts, mask, rand, explore) ->
    (sel [B,N] int8, util [B], greedy-baseline util [B], acts [B,N,H])
    where rand [B,N] are uniform draws, explore [B] bool selects the graphs
    that explore, and acts is the value tensor actually used (model
    outputs in the weights' dtype, head 0 overwritten by rand on explored
    graphs). Two LGS launches per call. The scoring forward runs on a
    (per-call) cast copy in bf16 mode; the model's own parameters, which
    the replay updates, stay f32.
    """
    dtype = _compute_dtype(flags)

    @torch.no_grad()
    def solve(adj, wts, mask, rand, explore):
        features, supports = build_state_arrays(
            adj, wts, mask, flags.feature_size, flags.max_degree,
            flags.predict, feature_mode)
        net = cast_model(model, dtype)
        acts = net(features.to(dtype), supports.to(dtype)).to(wts.dtype)
        m = mask.to(wts.dtype)
        ex = explore[:, None].to(wts.dtype)
        act0 = ex * rand * m + (1.0 - ex) * (acts[..., 0] * m)
        acts[..., 0] = act0
        gcn_wts = act0 * wts if flags.predict == "mwis" else act0
        sel = batched_lgs(adj, gcn_wts, mask)[0]
        gutil = batched_lgs(adj, wts, mask)[1]
        return sel, selected_utility(sel, wts), gutil, acts

    return solve


def make_resident_pipeline(model, flags: Config, feature_mode: str = "gdpg"):
    """Returns solve(supports, adjb, wts, mask) -> (sel [B,N] int8,
    util [B]) for a pinned graph: the support stack [B,S,N,N] (already in
    the compute dtype) and the adjacency are built once by the caller; per
    slot only the weights and the [B,N,F] features change."""
    dtype = _compute_dtype(flags)

    @torch.no_grad()
    def solve(supports, adjb, wts, mask):
        features = build_features(wts, mask, flags.feature_size,
                                  flags.predict, feature_mode)
        net = cast_model(model, dtype)
        gcn_wts = gcn_weights(net, features.to(dtype), supports, wts, mask,
                              flags.predict)
        sel = batched_lgs(adjb, gcn_wts, mask)[0]
        return sel, selected_utility(sel, wts)

    return solve


class BatchedEvaluator:
    """Evaluate an agent's GCN-LGS over a dataset in device batches.

    `agent` is any object with `model`, `flags` and `feature_mode`; its
    model lives on `device`. Instances are grouped by padding bucket,
    `batch_size` graphs per launch.
    """

    def __init__(self, agent, batch_size: int = 64, device=None):
        self.agent = agent
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._pipe = make_solve_pipeline(agent.model, agent.flags,
                                         agent.feature_mode)

    def evaluate(self, instances) -> Tuple[np.ndarray, np.ndarray]:
        """instances: list of (adj, wts). Returns (gcn_utils, greedy_utils)."""
        order = np.argsort([a.shape[0] for a, _ in instances], kind="stable")
        utils = np.zeros(len(instances))
        gutils = np.zeros(len(instances))
        pad_to = self.agent.flags.pad_to
        for i in range(0, len(order), self.batch_size):
            chunk = order[i: i + self.batch_size]
            adjs = [instances[j][0] for j in chunk]
            wtss = [instances[j][1] for j in chunk]
            bucket = pad_bucket(max(a.shape[0] for a in adjs), pad_to)
            gb = GraphBatch.from_scipy(adjs, wtss, pad_to=bucket,
                                       device=self.device)
            _, util, gutil = self._pipe(gb.adj, gb.wts, gb.mask)
            utils[chunk] = util.cpu().numpy()
            gutils[chunk] = gutil.cpu().numpy()
        return utils, gutils
