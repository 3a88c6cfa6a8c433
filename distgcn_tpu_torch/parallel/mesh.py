"""Sharded batched inference: graphs of a batch split over the ranks.

Port of the solve half of `distgcn_tpu/parallel/mesh.py`
(`make_sharded_solve`). The JAX package shards the batch over a ``data``
mesh axis and lets GSPMD partition one jitted program; here each rank runs
`pipeline.make_solve_pipeline` on its rows of the batch and the results
are gathered (`parallel.distributed.gather_global`). The data-parallel
train step comes with the trainers.
"""

from __future__ import annotations

from distgcn_tpu_torch.parallel.distributed import gather_global, rank_world
from distgcn_tpu_torch.pipeline import make_solve_pipeline
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.device import resolve_device


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
