"""Port parity: the (data, model) grid and the data-parallel train step
(`parallel/mesh.py`) against the JAX package's on its 8 virtual CPU
devices.

The train step runs on the inputs, config and tolerances of
`tests/test_parallel.py:131-180` (loss rel 1e-5, parameters atol 1e-6),
against JAX's step on the 8-device data mesh and on the one-device mesh:
in this process (D=1) and as 2 (2x1) and 4 (4x1 and 2x2) gloo ranks (this
file is also the worker; see `tests/test_torch_sharded.py`). A second
schedule runs two steps with ``learning_decay < 1``, so the optimizer's
count passes through the decay schedule. The grid's rank -> (data, model)
map and `param_sharding`'s column slices are held against JAX's
`make_mesh` devices and `param_sharding` specs without processes.
"""

import numpy as np
import pytest
import torch

from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.parallel import mesh as M
from distgcn_tpu_torch.rl.train import make_optimizer
from distgcn_tpu_torch.utils.config import Config
from test_torch_sharded import WORLDS, run_worlds, worker_main

CFG = dict(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
           max_degree=1, predict="mwis", pad_to=64, learning_rate=1e-3)
# schedule -> (learning_decay, steps)
SCHEDULES = {"constant": (1.0, 1), "decay": (0.5, 2)}
# layouts (n_data, n_model) of each world size
LAYOUTS = {1: ((1, 1),), 2: ((2, 1),), 4: ((4, 1), (2, 2))}
LOSS_REL, PARAM_ATOL = 1e-5, 1e-6


def _tree(inputs, prefix="p/"):
    tree = {}
    for key, v in inputs.items():
        if key.startswith(prefix):
            _, layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = v
    return tree


def run_port(inputs: dict, rank: int, world: int) -> dict:
    """Every layout of this world and every schedule: the losses of each
    step and the parameters after the last, under
    ``<n_data>x<n_model>/<schedule>/``."""
    out = {}
    batch = [torch.from_numpy(np.array(inputs[k]))
             for k in ("adj", "wts", "maskf", "labels")]
    for n_data, n_model in LAYOUTS[world]:
        mesh = M.make_mesh(n_data, n_model)
        assert (mesh.data_index, mesh.model_index) == divmod(rank, n_model)
        for sched, (decay, steps) in SCHEDULES.items():
            cfg = Config(**CFG, learning_decay=decay)
            model = make_model_from_config(
                cfg, "gcn_dqn", params=params_from_jax(_tree(inputs)),
                device="cpu")
            opt = make_optimizer(cfg.learning_rate, cfg.learning_decay)
            state = opt.init(dict(model.named_parameters()))
            step = M.make_sharded_train_step(model, cfg, opt, mesh)
            losses = []
            for _ in range(steps):
                state, loss = step(state, *batch)
                losses.append(float(loss))
            assert state["count"] == steps
            tag = f"{n_data}x{n_model}/{sched}"
            out[f"{tag}/loss"] = np.array(losses)
            for k, v in model.state_dict().items():
                out[f"{tag}/p/{k}"] = v.numpy()
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """`tests/test_parallel.py:131-160`'s batch and Flax init."""
    import jax
    import jax.numpy as jnp
    from conftest import random_graph
    from distgcn_tpu.core.graph import GraphBatch
    from distgcn_tpu.models.gcn import make_model_from_config as jax_model
    from distgcn_tpu.utils.config import Config as JConfig

    rng = np.random.default_rng(0)
    b, n = 8, 64
    adjs, wtss = [], []
    for _ in range(b):
        adjs.append(random_graph(rng, 40, 0.1))
        wtss.append(rng.random(40))
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=n)
    params = jax_model(JConfig(**CFG), "gcn_dqn").init(
        jax.random.PRNGKey(0), jnp.zeros((1, n, 1)),
        jnp.zeros((1, 2, n, n)))["params"]
    labels = rng.random((b, n, 1)).astype(np.float32)
    inp = {"adj": np.asarray(gb.adj), "wts": np.asarray(gb.wts),
           "maskf": np.asarray(gb.mask, np.float32), "labels": labels,
           **{f"p/{layer}/{leaf}": np.asarray(v, np.float32)
              for layer, leaves in params.items()
              for leaf, v in leaves.items()}}
    path = tmp_path_factory.mktemp("mesh")
    np.savez(path / "inputs.npz", **inp)
    return path, inp


@pytest.fixture(scope="module")
def port(inputs):
    path, inp = inputs
    results = {1: [run_port(inp, 0, 1)]}
    results.update(run_worlds(__file__, path, WORLDS))
    return results


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """JAX's `make_sharded_train_step` on the 8-device data mesh and on
    the one-device mesh, each schedule."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from distgcn_tpu.models.gcn import make_model_from_config as jax_model
    from distgcn_tpu.parallel import mesh as JM
    from distgcn_tpu.rl.train import make_optimizer as jax_optimizer
    from distgcn_tpu.utils.config import Config as JConfig

    _, inp = inputs
    batch = [jnp.asarray(inp[k]) for k in ("adj", "wts", "maskf", "labels")]
    out = {}
    for sched, (decay, steps) in SCHEDULES.items():
        cfg = JConfig(**CFG, learning_decay=decay)
        model = jax_model(cfg, "gcn_dqn")
        opt = jax_optimizer(cfg.learning_rate, cfg.learning_decay)
        for name, mesh in (("mesh8", JM.make_mesh(n_data=8, n_model=1)),
                           ("mesh1", JM.make_mesh(n_data=1, n_model=1))):
            params = jax.tree_util.tree_map(jnp.asarray, _tree(inp))
            state = opt.init(params)
            losses = []
            with mesh:
                step = JM.make_sharded_train_step(model, cfg, opt, mesh)
                put = lambda x: jax.device_put(  # noqa: E731
                    x, NamedSharding(mesh, P("data")))
                args = [put(x) for x in batch]
                for _ in range(steps):
                    params, state, loss = step(params, state, *args)
                    losses.append(float(loss))
            out[name, sched] = (np.array(losses), {
                f"{layer}.{leaf}": np.asarray(v)
                for layer, leaves in params.items()
                for leaf, v in leaves.items()})
    return out


CASES = [(world, layout) for world in LAYOUTS for layout in LAYOUTS[world]]


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("world,layout", CASES)
def test_sharded_train_step_matches_jax(port, jax_ref, world, layout, sched):
    tag = f"{layout[0]}x{layout[1]}/{sched}"
    for ref in ("mesh8", "mesh1"):
        want_loss, want_params = jax_ref[ref, sched]
        for r in port[world]:
            np.testing.assert_allclose(r[f"{tag}/loss"], want_loss,
                                       rtol=LOSS_REL)
            for k, v in want_params.items():
                np.testing.assert_allclose(r[f"{tag}/p/{k}"], v,
                                           atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_parameters(port, world):
    for r in port[world][1:]:
        for k, v in port[world][0].items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_step_equals_single_process_autograd(inputs):
    """At D=1 the step is autograd of JAX's loss and one TF1 Adam update,
    bit for bit."""
    from distgcn_tpu_torch.agents import build_state_arrays
    from distgcn_tpu_torch.rl.train import apply_updates, first_layer_l2
    _, inp = inputs
    adj, wts, maskf, labels = [torch.from_numpy(np.array(inp[k])) for k in
                               ("adj", "wts", "maskf", "labels")]
    cfg = Config(**CFG)
    models = [make_model_from_config(
        cfg, "gcn_dqn", params=params_from_jax(_tree(inp)), device="cpu")
        for _ in range(2)]
    opt = make_optimizer(cfg.learning_rate)
    states = [opt.init(dict(m.named_parameters())) for m in models]
    _, loss = M.make_sharded_train_step(models[0], cfg, opt,
                                        M.make_mesh())(states[0], adj, wts,
                                                       maskf, labels)
    feats, sups = build_state_arrays(adj, wts, maskf > 0, 1, 1, "mwis")
    out = models[1](feats, sups)
    mse = (((out[..., :1] - labels) ** 2)[..., 0] * maskf).sum(-1) \
        / maskf.sum(-1).clamp(min=1.0)
    want = torch.sqrt(mse).sum() / 8 + cfg.weight_decay * first_layer_l2(
        models[1])
    params = dict(models[1].named_parameters())
    grads = torch.autograd.grad(want, list(params.values()))
    updates, _ = opt.update(dict(zip(params, grads)), states[1])
    apply_updates(params, updates)
    assert float(loss) == float(want.detach())
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (8, 1), (2, 4), (1, 8)])
def test_grid_matches_jax_make_mesh(n_data, n_model):
    """Rank r sits where JAX's `make_mesh` puts device r of 8."""
    from distgcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    jm = jax_make_mesh(n_data, n_model)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    g = M.grid(8, n_data, n_model)
    np.testing.assert_array_equal(g, ids)
    for r in range(8):
        mesh = M.Mesh(g, r)
        assert mesh.shape == dict(jm.shape)
        assert (mesh.data_index, mesh.model_index) == tuple(
            int(i) for i in np.argwhere(ids == r)[0])


def test_grid_and_make_mesh_reject_a_bad_shape():
    assert M.grid(8, n_model=2).shape == (4, 2)
    with pytest.raises(ValueError, match="does not cover"):
        M.grid(8, 3, 2)
    with pytest.raises(ValueError, match="does not cover"):
        M.make_mesh(2, 1)                 # world 1 in this process
    assert M.make_mesh().shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_param_sharding_matches_jax_specs(n_model):
    """The column slice of each parameter on every rank of a
    (8 / n_model, n_model) grid equals the index JAX's `param_sharding`
    gives that device, on the same l20 c32 tree."""
    import jax
    import jax.numpy as jnp
    from distgcn_tpu.models.gcn import make_model_from_config as jax_model
    from distgcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from distgcn_tpu.parallel.mesh import param_sharding as jax_sharding
    from distgcn_tpu.utils.config import Config as JConfig

    kw = dict(CFG, hidden1=32, num_layer=20)
    tree = jax_model(JConfig(**kw), "gcn2_dqn").init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 1)),
        jnp.zeros((1, 2, 16, 16)))["params"]
    jm = jax_make_mesh(8 // n_model, n_model)
    specs = jax_sharding(jm, tree)
    model = make_model_from_config(Config(**kw), "gcn2_dqn",
                                   params=params_from_jax(tree), device="cpu")
    split = 0
    for r, dev in enumerate(jax.devices()[:8]):
        got = M.param_sharding(M.Mesh(M.grid(8, 8 // n_model, n_model), r),
                               dict(model.named_parameters()))
        assert set(got) == {f"{layer}.{leaf}" for layer in tree
                            for leaf in tree[layer]}
        for layer, leaves in tree.items():
            for leaf, x in leaves.items():
                idx = specs[layer][leaf].devices_indices_map(x.shape)[dev]
                cols = got[f"{layer}.{leaf}"]
                want = idx[1] if x.ndim == 2 else slice(None)
                n = x.shape[-1]
                assert cols.indices(n) == want.indices(n), (layer, leaf, r)
                split += cols.indices(n) != slice(None).indices(n)
    assert (split > 0) == (n_model > 1)


def test_batch_sharding_rows():
    g = M.grid(4, 2, 2)
    rows = [M.batch_sharding(M.Mesh(g, r))(8) for r in range(4)]
    assert rows == [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]
    with pytest.raises(ValueError, match="does not split"):
        M.batch_sharding(M.Mesh(g, 0))(3)


if __name__ == "__main__":
    worker_main(run_port)
