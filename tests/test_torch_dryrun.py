"""Port parity: the multi-card dry run (`distgcn_tpu_torch.dryrun`) and
the flagship solve against the JAX package's, on its 8 virtual CPU
devices (Pallas in interpret mode).

`dryrun_multichip` runs as one rank in this process (D=1) and as 4 gloo
processes (D=4: the 2x2 grid; this file is also the worker, see
`tests/test_torch_sharded.py`), on JAX's ``PRNGKey(0)`` parameters. Its
loss, mean utility and giant-graph utility are held against the same
quantities computed with the JAX package's functions the way
`__graft_entry__.py:84-134` computes them, at rtol 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distgcn_tpu_torch import dryrun
from distgcn_tpu_torch.models.gcn import params_from_jax
from test_torch_sharded import run_worlds, worker_main

RTOL = 1e-5
KEYS = ("loss", "mean_util", "giant_graph_util")
FLAGSHIP = dict(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                max_degree=1, predict="mwis", pad_to=128, batch_size=8)


def jax_config():
    from distgcn_tpu.utils.config import Config as JConfig
    return JConfig(**FLAGSHIP)


def jax_params() -> dict:
    """The JAX flagship's ``PRNGKey(0)`` init, flattened to
    ``p/<layer>/<leaf>``."""
    import jax
    import jax.numpy as jnp
    from distgcn_tpu.models.gcn import make_model_from_config
    tree = make_model_from_config(jax_config(), "gcn_dqn").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 1)),
        jnp.zeros((1, 2, 64, 64)))["params"]
    return {f"p/{layer}/{leaf}": np.asarray(v, np.float32)
            for layer, leaves in tree.items() for leaf, v in leaves.items()}


def port_params(inputs) -> dict:
    tree = {}
    for key, v in inputs.items():
        _, layer, leaf = key.split("/")
        tree.setdefault(layer, {})[leaf] = v
    return params_from_jax(tree)


def jax_dryrun(n_devices: int, flat: dict) -> dict:
    """`__graft_entry__.dryrun_multichip`'s quantities, computed with the
    JAX package's functions on the first n_devices virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from distgcn_tpu.core.graph import GraphBatch
    from distgcn_tpu.large import geometric_conflict_graph, params_to_list
    from distgcn_tpu.models.gcn import make_model_from_config
    from distgcn_tpu.parallel.large_sharded import (
        make_sharded_large_solve, shard_arrays, shard_large_graph)
    from distgcn_tpu.parallel.mesh import (make_mesh, make_sharded_solve,
                                           make_sharded_train_step)
    from distgcn_tpu.rl.train import make_optimizer

    cfg = jax_config()
    model = make_model_from_config(cfg, "gcn_dqn")
    params = {}
    for key, v in flat.items():
        _, layer, leaf = key.split("/")
        params.setdefault(layer, {})[leaf] = jnp.asarray(v)
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_data=n_devices // n_model, n_model=n_model)
    rng = np.random.default_rng(0)
    n, b = 64, max(2 * n_devices // n_model, 2)
    adjs, wtss = [], []
    for _ in range(b):
        a = np.triu(rng.random((40, 40)) < 0.1, 1)
        adjs.append(sp.csr_matrix((a + a.T).astype(np.float32)))
        wtss.append(rng.random(40))
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=n)
    optimizer = make_optimizer(cfg.learning_rate, cfg.learning_decay)
    opt_state = optimizer.init(params)
    labels = jnp.asarray(rng.random((b, n, 1)), dtype=jnp.float32)
    with mesh:
        put = lambda x: jax.device_put(x, NamedSharding(mesh, P("data")))
        adj, wts, mask, lab = map(put, (gb.adj, gb.wts,
                                        gb.mask.astype(jnp.float32), labels))
        step = make_sharded_train_step(model, cfg, optimizer, mesh)
        params2, _, loss = step(params, opt_state, adj, wts, mask, lab)
        solve = make_sharded_solve(model, cfg, mesh)
        _, util, _ = solve(params2, adj, wts, put(gb.mask))
    gmesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("graph",))
    ladj, lwts, _ = geometric_conflict_graph(16 * n_devices, avg_degree=6.0,
                                             seed=5)
    sg = shard_large_graph(ladj, n_devices, block_size=8, interpret=True)
    lsolve = make_sharded_large_solve(gmesh, sg)
    wpad = np.zeros(sg.n_pad, np.float32)
    wpad[: sg.n] = lwts
    wsh = jax.device_put(jnp.asarray(wpad), NamedSharding(gmesh, P("graph")))
    _, lutil = lsolve(*shard_arrays(gmesh, sg)[:4], params_to_list(params2),
                      wsh, shard_arrays(gmesh, sg)[4])
    return {"loss": float(loss), "mean_util": float(util.mean()),
            "giant_graph_util": float(np.asarray(lutil)[0])}


def run_port(inputs: dict, rank: int, world: int) -> dict:
    out = dryrun.dryrun_multichip(world, device="cpu",
                                  params=port_params(inputs))
    return {"grid": np.array([out["mesh"]["data"], out["mesh"]["model"]]),
            **{k: np.float64(out[k]) for k in KEYS}}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun")
    flat = jax_params()
    np.savez(path / "inputs.npz", **flat)
    return path, flat


@pytest.fixture(scope="module")
def port(inputs):
    path, flat = inputs
    results = {1: [run_port(flat, 0, 1)]}
    results.update(run_worlds(__file__, path, worlds=(4,)))
    return results


@pytest.fixture(scope="module")
def jax_ref(inputs):
    return {d: jax_dryrun(d, inputs[1]) for d in (1, 4)}


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("world", (1, 4))
def test_dryrun_matches_jax(port, jax_ref, world, key):
    for r in port[world]:
        assert r["grid"].tolist() == ([2, 2] if world == 4 else [1, 1])
        assert float(r[key]) == pytest.approx(jax_ref[world][key], rel=RTOL)


def test_dryrun_returns_valid_schedules(inputs):
    out = dryrun.dryrun_multichip(1, device="cpu",
                                  params=port_params(inputs[1]))
    assert out["mesh"] == {"data": 1, "model": 1}
    sel, adj, mask = out["sel"], out["adj"] > 0, out["mask"]
    on = sel == 1
    assert not bool((adj & on[:, :, None] & on[:, None, :]).any())
    assert bool((on | (adj & on[:, None, :]).any(-1))[mask].all())
    gsel = out["giant_sel"].numpy()
    ladj = out["giant_adj"]
    picked = np.flatnonzero(gsel == 1)
    assert ladj[picked][:, picked].nnz == 0
    covered = np.zeros(gsel.size, bool)
    covered[picked] = True
    covered[np.unique(ladj[picked].indices)] = True
    assert covered.all()


def test_dryrun_needs_the_group_size():
    with pytest.raises(ValueError, match="process group of 1"):
        dryrun.dryrun_multichip(2, device="cpu")


def test_entry_matches_jax_flagship(inputs):
    """The flagship solve on JAX's parameters: the port's batch equals
    `__graft_entry__.entry`'s, and so do its selections and utilities."""
    import jax
    import jax.numpy as jnp
    from distgcn_tpu.core.graph import GraphBatch
    from distgcn_tpu.models.gcn import make_model_from_config
    from distgcn_tpu.pipeline import make_solve_pipeline
    from distgcn_tpu_torch.pipeline import make_solve_pipeline as port_pipe

    fn, (adj, wts, mask) = dryrun.entry("cpu")
    assert adj.shape == (8, 128, 128) and wts.shape == mask.shape == (8, 128)
    sel, util, gutil = fn(adj, wts, mask)
    assert sel.shape == (8, 128) and bool(torch.isfinite(util).all())

    cfg = jax_config()
    rng = np.random.default_rng(0)
    adjs, wtss = [], []
    for _ in range(8):
        a = np.triu(rng.random((100, 100)) < 0.06, 1)
        adjs.append(sp.csr_matrix((a + a.T).astype(np.float32)))
        wtss.append(rng.random(100))
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=128)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(gb.adj))
    np.testing.assert_array_equal(wts.numpy(), np.asarray(gb.wts))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(gb.mask))
    flat = inputs[1]
    params = {}
    for key, v in flat.items():
        _, layer, leaf = key.split("/")
        params.setdefault(layer, {})[leaf] = jnp.asarray(v)
    jsel, jutil, jgutil = jax.jit(make_solve_pipeline(
        make_model_from_config(cfg, "gcn_dqn"), cfg))(params, gb.adj, gb.wts,
                                                      gb.mask)
    model = dryrun._flagship_model(dryrun.flagship_config(), "cpu",
                                   port_params(flat))
    psel, putil, pgutil = port_pipe(model, dryrun.flagship_config())(
        adj, wts, mask)
    np.testing.assert_array_equal(psel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(putil.numpy(), np.asarray(jutil), rtol=RTOL)
    np.testing.assert_allclose(pgutil.numpy(), np.asarray(jgutil), rtol=RTOL)


if __name__ == "__main__":
    worker_main(run_port)
