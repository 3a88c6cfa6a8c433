"""Driver entry points: the flagship solve and the multi-card dry run.

The port's counterpart of the JAX package's ``__graft_entry__.py``:

- `entry` builds the flagship solve: the 20-layer c32 `gcn_dqn` ChebGCN
  (the reference's deepest production model, bash/train_gcn_dqn.sh) on 8
  seeded random graphs of 100 nodes padded to 128;
- `dryrun_multichip` runs, in one program over the process group, the
  sharded data-parallel train step (`parallel.mesh`), the sharded batch
  solve with the updated parameters and the sharded giant-graph solve
  (`parallel.large_sharded`), on the JAX dry run's seeded inputs.

Run both from the repository root (one rank; D ranks with the DISTGCN_*
environment of `parallel.distributed`, one card each):

    python -m distgcn_tpu_torch.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.large import geometric_conflict_graph, params_to_list
from distgcn_tpu_torch.models.gcn import make_model_from_config, params_to_jax
from distgcn_tpu_torch.parallel import distributed
from distgcn_tpu_torch.parallel.large_sharded import (make_sharded_large_solve,
                                                      shard_arrays,
                                                      shard_large_graph)
from distgcn_tpu_torch.parallel.mesh import (make_mesh, make_sharded_solve,
                                             make_sharded_train_step)
from distgcn_tpu_torch.pipeline import make_solve_pipeline
from distgcn_tpu_torch.rl.train import make_optimizer
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.device import resolve_device


def flagship_config() -> Config:
    """The flagship: 20-layer c32 ChebGCN-DQN, feature 1, on a batch of 8
    graphs padded to 128 nodes."""
    return Config(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                  max_degree=1, predict="mwis", pad_to=128, batch_size=8)


def _flagship_model(cfg: Config, dev, params=None):
    """`gcn_dqn` at `cfg` on `dev`: `params` (a state_dict, e.g. from
    `models.gcn.params_from_jax`), else drawn from a generator seeded 0."""
    return make_model_from_config(cfg, "gcn_dqn", params=params,
                                  generator=torch.Generator().manual_seed(0),
                                  device=dev)


def _random_batch(rng, b: int, n: int, p: float, pad_to: int, dev):
    """b seeded graphs of n nodes, edge probability p, U(0,1) weights, in
    the JAX dry run's draw order."""
    adjs, wtss = [], []
    for _ in range(b):
        a = np.triu(rng.random((n, n)) < p, 1)
        adjs.append(sp.csr_matrix((a + a.T).astype(np.float32)))
        wtss.append(rng.random(n))
    return GraphBatch.from_scipy(adjs, wtss, pad_to=pad_to, device=dev)


def entry(device=None):
    """The flagship solve on one device: returns (fn, (adj, wts, mask)),
    fn the `make_solve_pipeline` of the seeded flagship model, which maps
    the batch to (sel [8, 128] int8, util [8], greedy-baseline util [8])."""
    dev = resolve_device(device)
    cfg = flagship_config()
    gb = _random_batch(np.random.default_rng(0), 8, 100, 0.06, cfg.pad_to,
                       dev)
    fn = make_solve_pipeline(_flagship_model(cfg, dev), cfg)
    return fn, (gb.adj, gb.wts, gb.mask)


def dryrun_multichip(n_devices: int, device=None,
                     params: Optional[dict] = None) -> dict:
    """One sharded train step, the sharded batch solve and the sharded
    giant-graph solve over the process group (`__graft_entry__.py:49-139`).

    n_devices must be the group's size (1 with no group). The grid is
    (n_devices // n_model, n_model) with n_model = 2 when n_devices is
    even and >= 4. The train step runs on b = max(2 n_devices / n_model, 2)
    seeded graphs of 40 nodes padded to 64 with seeded labels, then the
    batch solve with the updated parameters, then `make_sharded_large_solve`
    on `geometric_conflict_graph(16 n_devices, avg_degree=6, seed=5)`.
    The JAX dry run shards that graph in 8-wide blocks; the CUDA wrappers
    take multiples of 32 (`ops/spmm_cuda.py`), so on a card the blocks are
    32 wide (`shard_large_graph` pads n to block_size x D); on the CPU
    they are JAX's 8.

    `params` is the model's state_dict (the tests pass JAX's through
    `models.gcn.params_from_jax`); None draws the port's seeded init.
    Prints the JAX line's fields and returns them (mesh, loss, mean_util,
    giant_graph_util) with the selections and the graphs they hold: sel,
    adj, mask of the batch, giant_sel and giant_adj of the giant graph.
    """
    rank, world = distributed.rank_world()
    if n_devices != world:
        raise ValueError(f"dryrun_multichip({n_devices}) in a process group "
                         f"of {world}")
    dev = resolve_device(device)
    cfg = flagship_config()
    model = _flagship_model(cfg, dev, params)
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_data=n_devices // n_model, n_model=n_model)

    rng = np.random.default_rng(0)
    n = 64
    b = max(2 * n_devices // n_model, 2)
    gb = _random_batch(rng, b, 40, 0.1, n, dev)
    labels = torch.from_numpy(rng.random((b, n, 1)).astype(np.float32)
                              ).to(dev)
    maskf = gb.mask.to(torch.float32)

    optimizer = make_optimizer(cfg.learning_rate, cfg.learning_decay)
    opt_state = optimizer.init(dict(model.named_parameters()))
    step = make_sharded_train_step(model, cfg, optimizer, mesh)
    opt_state, loss = step(opt_state, gb.adj, gb.wts, maskf, labels)
    solve = make_sharded_solve(model, cfg, device=dev)
    sel, util, _ = solve(gb.adj, gb.wts, gb.mask)

    ladj, lwts, _ = geometric_conflict_graph(16 * n_devices, avg_degree=6.0,
                                             seed=5)
    sg = shard_large_graph(ladj, n_devices,
                           block_size=32 if dev.type == "cuda" else 8)
    if not (sg.separable and sg.vals is None):
        raise RuntimeError("the giant graph is not an int8/bitmap-only "
                           "panel stream")
    lsolve = make_sharded_large_solve(sg, device=dev)
    a = shard_arrays(sg, device=dev)
    wpad = np.zeros(sg.n_pad, np.float32)
    wpad[:sg.n] = lwts
    plist = params_to_list(params_to_jax(model.state_dict()), device=dev)
    lsel, lutil = lsolve(*a[:4], plist,
                         distributed.host_to_local(wpad, rank, world, dev),
                         a[4])
    out = {"mesh": mesh.shape, "loss": float(loss),
           "mean_util": float(util.mean()), "giant_graph_util": float(lutil)}
    print(f"dryrun_multichip OK: mesh={out['mesh']} loss={out['loss']:.4f} "
          f"mean_util={out['mean_util']:.3f} "
          f"giant_graph_util={out['giant_graph_util']:.3f}", flush=True)
    return {**out, "sel": sel, "adj": gb.adj, "mask": gb.mask,
            "giant_sel": distributed.gather_global(lsel)[:sg.n],
            "giant_adj": ladj}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    joined = distributed.initialize(device=dev)
    try:
        fn, fargs = entry(dev)
        out = fn(*fargs)
        print("entry OK:", [tuple(o.shape) for o in out], flush=True)
        dryrun_multichip(distributed.rank_world()[1], device=dev)
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
