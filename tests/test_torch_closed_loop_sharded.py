"""Port parity: the data-sharded closed-loop episode
(`sim/device_sim.make_closed_loop(..., mesh=)`) against the JAX package's
sharded episode on its 8 virtual CPU devices and against the port's own
unsharded episode.

The batch, agent and length are the JAX test's
(`tests/test_device_sim.py:181-199`: 8 graphs of 24 nodes padded to 32, the
2-layer hidden-8 `gcn_dqn` agent, T=30). The port runs in this process
(world 1) and as 2 (2x1) and 4 (4x1 and 2x2) gloo ranks: this file is also
the worker (see `tests/test_torch_sharded.py`), which imports only torch
and the port.

- Against JAX: the two packages share no RNG stream, so the traffic draws
  nothing random: load 0 gives no arrivals (the Poisson table of rate 0 is
  ``[1]``) and ``rate_lo == rate_hi`` fixes the rates; the queues start
  from seeded integers on the real nodes. gdpg and dqn, f32, with the
  greedy baseline; queueT and every metric within rtol 1e-5, the JAX
  test's tolerance.
- Against the unsharded episode: random traffic at load 0.5 on one
  generator seed, gdpg and dqn in f32 and gdpg in bf16, bit for bit.
"""

import numpy as np
import pytest
import torch

from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.parallel import mesh as M
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.utils.config import Config
from test_torch_mesh import LAYOUTS, _tree
from test_torch_sharded import WORLDS, run_worlds, worker_main

CFG = dict(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
           max_degree=1, predict="mwis", pad_to=32, batch_size=4,
           epsilon=0.0)
TIMESLOTS = 30
RTOL = 1e-5
# traffic that draws nothing random: no arrivals, every rate 10
PINNED = dict(load=0.0, rate_lo=10.0, rate_hi=10.0)
PINNED_MODES = ("gdpg", "dqn")
# random traffic: (feature mode, compute dtype)
RANDOM = (("gdpg", "float32"), ("dqn", "float32"), ("gdpg", "bfloat16"))
RANDOM_LOAD, SEED = 0.5, 3
CASES = [(world, layout) for world in LAYOUTS for layout in LAYOUTS[world]]


def _run(inputs, mesh, feature_mode, compute_dtype="float32", **traffic):
    cfg = Config(**CFG, compute_dtype=compute_dtype)
    model = make_model_from_config(cfg, "gcn_dqn",
                                   params=params_from_jax(_tree(inputs)),
                                   device="cpu")
    return device_sim.make_closed_loop(
        model, cfg, TIMESLOTS, feature_mode=feature_mode, with_baseline=True,
        mesh=mesh, **traffic)


def episodes(inputs: dict, mesh=None) -> dict:
    """queueT and the metrics of every case, under ``pinned/<mode>/`` and
    ``random/<mode>/<dtype>/``."""
    adj, mask, queue0 = (torch.from_numpy(np.array(inputs[k]))
                         for k in ("adj", "mask", "queue0"))
    out = {}

    def put(tag, result):
        queue, metrics = result
        out[f"{tag}/queue"] = queue.numpy()
        out.update({f"{tag}/{k}": v.numpy() for k, v in metrics.items()})

    for mode in PINNED_MODES:
        run = _run(inputs, mesh, mode, **PINNED)
        put(f"pinned/{mode}", run(adj, mask, queue0,
                                  torch.Generator().manual_seed(0)))
    for mode, dt in RANDOM:
        run = _run(inputs, mesh, mode, dt, load=RANDOM_LOAD)
        put(f"random/{mode}/{dt}", run(adj, mask, torch.zeros_like(queue0),
                                       torch.Generator().manual_seed(SEED)))
    return out


def run_port(inputs: dict, rank: int, world: int) -> dict:
    """The unsharded episodes under ``ref/`` and every layout of this
    world's under ``<n_data>x<n_model>/``."""
    out = {f"ref/{k}": v for k, v in episodes(inputs).items()}
    for n_data, n_model in LAYOUTS[world]:
        mesh = M.make_mesh(n_data, n_model)
        out.update({f"{n_data}x{n_model}/{k}": v
                    for k, v in episodes(inputs, mesh).items()})
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX test's batch and agent; integer queues on the real nodes."""
    from conftest import random_graph
    from distgcn_tpu.agents import DQNAgent
    from distgcn_tpu.core.graph import GraphBatch
    from distgcn_tpu.utils.config import Config as JConfig

    rng = np.random.default_rng(0)
    adjs = [random_graph(rng, n=24, p=0.1) for _ in range(8)]
    gb = GraphBatch.from_scipy(adjs, [np.ones(24)] * 8, pad_to=32)
    mask = np.asarray(gb.mask)
    agent = DQNAgent(JConfig(**CFG), model_family="gcn_dqn")
    queue0 = rng.integers(0, 500, mask.shape).astype(np.float32) * mask
    inp = {"adj": np.asarray(gb.adj), "mask": mask, "queue0": queue0,
           **{f"p/{layer}/{leaf}": np.asarray(v, np.float32)
              for layer, leaves in agent.params.items()
              for leaf, v in leaves.items()}}
    path = tmp_path_factory.mktemp("closed_loop")
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
    """JAX's `make_closed_loop` on the 8-device data mesh, each pinned
    mode."""
    import jax
    import jax.numpy as jnp
    from distgcn_tpu.agents import DQNAgent
    from distgcn_tpu.parallel.mesh import make_mesh
    from distgcn_tpu.sim import device_sim as jsim
    from distgcn_tpu.utils.config import Config as JConfig

    _, inp = inputs
    cfg = JConfig(**CFG)
    agent = DQNAgent(cfg, model_family="gcn_dqn")
    params = jax.tree_util.tree_map(jnp.asarray, _tree(inp))
    mesh = make_mesh(n_data=8, n_model=1)
    out = {}
    for mode in PINNED_MODES:
        run = jsim.make_closed_loop(agent.model, cfg, TIMESLOTS,
                                    feature_mode=mode, with_baseline=True,
                                    mesh=mesh, **PINNED)
        queue, metrics = run(params, jnp.asarray(inp["adj"]),
                             jnp.asarray(inp["mask"]),
                             jnp.asarray(inp["queue0"]),
                             jax.random.PRNGKey(3))
        out[mode] = {"queue": np.asarray(queue),
                     **{k: np.asarray(v) for k, v in metrics.items()}}
    return out


@pytest.mark.parametrize("mode", PINNED_MODES)
@pytest.mark.parametrize("world,layout", CASES)
def test_sharded_episode_matches_jax(port, jax_ref, inputs, world, layout,
                                     mode):
    tag = f"{layout[0]}x{layout[1]}/pinned/{mode}"
    want = jax_ref[mode]
    assert set(want) == {"queue", "avg_queue_len", "avg_utility",
                         "sched_rate", "avg_utility_ratio"}
    # the queues drain, but not to 0
    assert 0 < want["queue"].sum() < inputs[1]["queue0"].sum()
    for r in port[world]:
        for k, v in want.items():
            np.testing.assert_allclose(r[f"{tag}/{k}"], v, rtol=RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("mode,dtype", RANDOM)
@pytest.mark.parametrize("world,layout", CASES)
def test_sharded_episode_equals_unsharded(port, world, layout, mode, dtype):
    case = f"random/{mode}/{dtype}"
    for r in port[world]:
        keys = [k for k in r if k.startswith(f"ref/{case}/")]
        assert len(keys) == 5
        for k in keys:
            got = r[k.replace("ref/", f"{layout[0]}x{layout[1]}/", 1)]
            assert got.shape == r[k].shape
            np.testing.assert_array_equal(got, r[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_whole_batch(port, inputs, world):
    b, n = inputs[1]["queue0"].shape
    first = port[world][0]
    for k, v in first.items():
        assert v.shape[0] == b and (not k.endswith("/queue")
                                    or v.shape == (b, n)), k
    for r in port[world][1:]:
        assert set(r) == set(first)
        for k, v in first.items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_sharded_loop_rejects_bad_inputs(inputs):
    _, inp = inputs
    adj, mask = (torch.from_numpy(np.array(inp[k]))
                 for k in ("adj", "mask"))
    mesh = M.Mesh(M.grid(3, 3, 1), 0)
    run = _run(inp, mesh, "gdpg", load=RANDOM_LOAD)
    with pytest.raises(ValueError, match="does not split over 3"):
        run(adj, mask, torch.zeros(mask.shape),
            torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        run(adj[:6], mask[:6], torch.zeros((6, mask.shape[1]),
                                           device="meta"),
            torch.Generator())


if __name__ == "__main__":
    worker_main(run_port)
