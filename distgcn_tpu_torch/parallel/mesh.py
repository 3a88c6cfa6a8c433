"""The (data, model) grid of ranks, the data-parallel train step and the
sharded batch solve.

Port of `distgcn_tpu/parallel/mesh.py`. The JAX package lays its devices
out on a ('data', 'model') mesh and lets GSPMD partition one jitted
program: batch arrays carry ``P('data')``, parameters are replicated and
XLA inserts the gradient all-reduce. Here every rank of the process group
(`parallel.distributed`; world 1 in this process when none is open) runs
its own program:

- `make_mesh` places rank r at data index ``r // n_model`` and model index
  ``r % n_model`` (the row-major reshape of the JAX package's device list)
  and opens the sub-groups that reduce over the data axis;
- `make_sharded_train_step` computes the loss and its gradients on this
  rank's rows of the batch and sums the gradients over the data axis with
  one all-reduce (NCCL between cards, gloo between CPU processes); every
  rank then applies the same optimizer update, so the parameters stay
  replicated, as in the JAX step (``in_shardings=(rspec, rspec, ...)``);
- `make_sharded_solve` splits the graphs of a batch over the ranks and
  all-gathers the results.

The ``model`` axis replicates the batch rows: the n_model ranks of one data
index compute the same rows, as GSPMD does for ``P('data')``.
`param_sharding` says which columns of each weight a rank of the model
axis would hold; nothing shards parameters on this path, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from distgcn_tpu_torch.agents import build_state_arrays
from distgcn_tpu_torch.parallel.distributed import gather_global, rank_world
from distgcn_tpu_torch.pipeline import make_solve_pipeline
from distgcn_tpu_torch.rl.train import apply_updates, first_layer_l2
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.device import resolve_device


def grid(world: int, n_data: Optional[int] = None,
         n_model: int = 1) -> np.ndarray:
    """The [n_data, n_model] grid of ranks 0..world-1, row-major: rank r
    at (r // n_model, r % n_model). n_data defaults to world // n_model;
    raises unless n_data * n_model == world."""
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) grid does not cover "
                         f"{world} ranks")
    return np.arange(world).reshape(n_data, n_model)


@dataclass(frozen=True)
class Mesh:
    """This rank's place on a ('data', 'model') grid.

    devices: the [n_data, n_model] grid of group ranks (the JAX mesh's
    ``devices``); rank: this process's rank in the group; data_group: the
    process group over this rank's column of the grid, which sums the
    gradients (None: the default group)."""
    devices: np.ndarray
    rank: int = 0
    data_group: object = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.devices.shape[0], "model": self.devices.shape[1]}

    @property
    def n_data(self) -> int:
        return self.devices.shape[0]

    @property
    def n_model(self) -> int:
        return self.devices.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              group=None) -> Mesh:
    """The ('data', 'model') grid over the ranks of `group` (default: the
    whole world; world 1 with no process group). n_data defaults to
    world // n_model; raises unless n_data * n_model is the group's size.

    Opens one sub-group per model index, the ranks of that grid column,
    over which the train step sums gradients. Every rank of the group
    must call this with the same arguments, in the same order: each rank
    takes part in creating every sub-group."""
    rank, world = rank_world(group)
    devices = grid(world, n_data, n_model)
    data_group = group
    if devices.shape[0] > 1 and devices.shape[1] > 1:
        members = (dist.get_process_group_ranks(group) if group is not None
                   else list(range(world)))
        for m in range(devices.shape[1]):
            sub = dist.new_group([members[r] for r in devices[:, m]])
            if m == rank % devices.shape[1]:
                data_group = sub
    return Mesh(devices, rank, data_group)


def batch_sharding(mesh: Mesh) -> Callable[[int], slice]:
    """``P('data')``: rows(b) is the slab of a batch of b graphs that this
    rank holds, rows [i * b / n_data, (i + 1) * b / n_data) for data index
    i. The model axis is replicated: the n_model ranks of one data index
    hold the same rows."""
    def rows(b: int) -> slice:
        if b % mesh.n_data:
            raise ValueError(f"a batch of {b} graphs does not split over "
                             f"{mesh.n_data} data ranks")
        k = b // mesh.n_data
        return slice(mesh.data_index * k, (mesh.data_index + 1) * k)
    return rows


def param_sharding(mesh: Mesh, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, slice]:
    """For each parameter (name -> tensor, as `named_parameters` gives
    them), the columns this rank would hold: a 2-D weight whose output
    dimension divides by n_model (and is >= n_model) is split over the
    model axis, ``P(None, 'model')``; everything else is replicated,
    ``P()``, and gets ``slice(None)`` (`distgcn_tpu/parallel/mesh.py:
    50-60`)."""
    m, n_model = mesh.model_index, mesh.n_model

    def spec(x) -> slice:
        if x.ndim == 2 and x.shape[1] % n_model == 0 \
                and x.shape[1] >= n_model:
            k = x.shape[1] // n_model
            return slice(m * k, (m + 1) * k)
        return slice(None)

    return {name: spec(x) for name, x in params.items()}


def make_sharded_train_step(model, flags: Config, optimizer, mesh: Mesh,
                            feature_mode: str = "gdpg"):
    """Data-parallel batched train step (`distgcn_tpu/parallel/mesh.py:
    62-101`). Returns step(opt_state, adj, wts, mask, labels) ->
    (opt_state, loss), which updates `model`'s parameters in place.

    Loss: the mean over the whole batch of each graph's RMSE against
    ``labels[..., :1]`` over its real nodes, plus weight_decay x l2 of the
    first layer (`rl.train.first_layer_l2`). Every rank passes the same
    batch (adj [B, N, N], wts [B, N], mask [B, N] float, labels [B, N, 1])
    on the model's device and computes on its rows (`batch_sharding`):
    their RMSE sum over B, and the l2 term on data index 0 alone, so the
    one all-reduce over the data axis, of the flattened gradients and the
    loss together, gives the whole batch's gradient and loss on every
    rank. Each rank then applies the same `optimizer` update; its state
    (``opt_state["count"]`` included) advances alike everywhere.
    """
    params = dict(model.named_parameters())
    names = list(params)
    rows = batch_sharding(mesh)
    wd = flags.weight_decay
    dev = next(iter(params.values())).device

    def step(opt_state, adj, wts, mask, labels):
        for t in (adj, wts, mask, labels):
            if t.device != dev:
                raise ValueError(f"the model lies on {dev}, got a batch on "
                                 f"{t.device}")
        b = wts.shape[0]
        sl = rows(b)
        m = mask[sl]
        features, supports = build_state_arrays(
            adj[sl], wts[sl], m > 0, flags.feature_size, flags.max_degree,
            flags.predict, feature_mode)
        out = model(features, supports)
        err = (out[..., :1] - labels[sl][..., :1]) ** 2
        mse = (err[..., 0] * m).sum(dim=-1) / torch.clamp(m.sum(dim=-1),
                                                         min=1.0)
        loss = torch.sqrt(mse).sum() / b
        if mesh.data_index == 0:
            loss = loss + wd * first_layer_l2(model)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        flat = torch.cat([(torch.zeros_like(params[k]) if g is None else g)
                          .reshape(-1) for k, g in zip(names, grads)]
                         + [loss.detach().reshape(1)])
        if mesh.n_data > 1:
            dist.all_reduce(flat, group=mesh.data_group)
        parts = torch.split(flat, [params[k].numel() for k in names] + [1])
        updates, opt_state = optimizer.update(
            {k: g.view_as(params[k]) for k, g in zip(names, parts)},
            opt_state)
        apply_updates(params, updates)
        return opt_state, parts[-1][0]

    return step


def make_sharded_solve(model, flags: Config, feature_mode: str = "gdpg",
                       with_baseline: bool = True, device=None, group=None):
    """Returns solve(adj, wts, mask) -> (sel [B,N] int8, util [B],
    greedy-baseline util [B]), the `make_solve_pipeline` contract, over the
    whole batch on every rank.

    Every rank passes the same batch (the data convention of
    `parallel.distributed`) on `device`, with B a multiple of the group's
    size; rank r solves rows [r*B/D, (r+1)*B/D) with `model` (on `device`,
    CUDA unless the caller passes ``device="cpu"``) and the slabs are
    all-gathered.
    """
    dev = resolve_device(device)
    inner = make_solve_pipeline(model, flags, feature_mode, with_baseline)

    def solve(adj, wts, mask):
        rank, world = rank_world(group)
        b = wts.shape[0]
        if b % world:
            raise ValueError(f"a batch of {b} graphs does not split over "
                             f"{world} ranks")
        if wts.device.type != dev.type:
            raise ValueError(f"the solve runs on {dev}, got a batch on "
                             f"{wts.device}")
        rows = slice(rank * (b // world), (rank + 1) * (b // world))
        out = inner(adj[rows], wts[rows], mask[rows])
        return tuple(gather_global(t.contiguous(), group) for t in out)

    return solve
