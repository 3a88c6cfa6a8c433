"""Port parity: the sharded runtime (`parallel.distributed`), the ring
helpers (`parallel.halo`), the sharded batch solve (`parallel.mesh`) and
the int32 neighbour-max, against the JAX package on its 8 virtual CPU
devices (Pallas in interpret mode).

The port runs as a one-rank ring in this process and as 2 and 4 gloo
processes: this file is also the worker (``python tests/test_torch_sharded.py
<inputs dir> <out dir>`` with the DISTGCN_* environment set), which imports
only torch and the port. Tolerances: ranks, selections and the int32
neighbour-max bit-equal; the dense ring products at
`tests/test_parallel.py`'s tolerances (atol 1e-3, 2e-3 for K=1 and 5e-3 for
K=2).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.ops.lgs import lgs_ranks
from distgcn_tpu_torch.ops.spmm import (I32_SENT, BsrMatrix, bsr_neighbor_max,
                                        bsr_nbr_max_plain, bsr_row_ptr,
                                        nbr_max_rows)
from distgcn_tpu_torch.parallel import distributed
from distgcn_tpu_torch.parallel.halo import (distributed_lgs_ranks,
                                             make_ring_spmm,
                                             make_sharded_gcn_forward,
                                             make_sharded_lgs)
from distgcn_tpu_torch.parallel.mesh import make_sharded_solve
from distgcn_tpu_torch.pipeline import make_solve_pipeline
from distgcn_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
WORKER_TIMEOUT_S = 120
MESH_CFG = dict(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
                max_degree=1, predict="mwis", pad_to=64)


# ---------------------------------------------------------------------------
# gloo workers
# ---------------------------------------------------------------------------

def run_worlds(script, inputs_dir: Path, worlds=WORLDS) -> dict:
    """Run `script` as a gloo process group of each size in `worlds`, all
    groups at once; each rank writes ``rank<r>.npz`` into
    ``<inputs_dir>/world<D>``. Returns {D: [each rank's results]}."""
    procs = {}
    base = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(REPO), os.environ.get("PYTHONPATH", "")]))
    for world in worlds:
        out = inputs_dir / f"world{world}"
        out.mkdir()
        for rank in range(world):
            env = dict(base, DISTGCN_COORDINATOR=f"file://{out / 'init'}",
                       DISTGCN_NUM_PROCESSES=str(world),
                       DISTGCN_PROCESS_ID=str(rank))
            procs[world, rank] = subprocess.Popen(
                [sys.executable, str(script), str(inputs_dir), str(out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    try:
        logs = {key: p.communicate(timeout=WORKER_TIMEOUT_S)[0]
                for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for (world, rank), p in procs.items():
        assert p.returncode == 0, (f"rank {rank} of {world} failed:\n"
                                   f"{logs[world, rank]}")
    return {world: [dict(np.load(inputs_dir / f"world{world}" /
                                 f"rank{rank}.npz"))
                    for rank in range(world)] for world in worlds}


def worker_main(run) -> None:
    """Join the group from the DISTGCN_* environment on the CPU, run
    ``run(inputs, rank, world)`` and save its dict of arrays."""
    import torch.distributed as dist
    inputs_dir, out_dir = Path(sys.argv[1]), Path(sys.argv[2])
    assert distributed.initialize(device="cpu")
    try:
        rank, world, _, _ = distributed.process_info()
        inputs = dict(np.load(inputs_dir / "inputs.npz"))
        np.savez(out_dir / f"rank{rank}.npz", **run(inputs, rank, world))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# inputs (numpy, seeded) and the port's side
# ---------------------------------------------------------------------------

def _random_graph(rng, n, p):
    a = np.triu((rng.random((n, n)) < p).astype(np.float32), 1)
    return a + a.T


def rank_inputs() -> dict:
    out = {}
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        n = 8 * 96
        w = rng.random(n).astype(np.float32)
        # heavy ties spanning shards, including runs of identical values
        w[rng.integers(0, n, 50)] = 0.5
        w[rng.integers(0, n, 25)] = 0.25
        w[:16] = 0.75              # a tie in every shard's first rows
        out[f"ranks/ties{seed}"] = w
    out["ranks/equal"] = np.full(8 * 32, 0.125, np.float32)
    # signed zeros (masked GCN scores come out as both), across shards
    rng = np.random.default_rng(2)
    w = rng.choice(np.array([0.0, -0.0, 0.5, -0.25], np.float32), 8 * 64)
    w[rng.integers(0, w.size, 40)] = rng.random(40).astype(np.float32) - 0.5
    out["ranks/signed_zeros"] = w
    return out


def dense_inputs() -> dict:
    rng = np.random.default_rng(0)
    n = 256
    a = _random_graph(rng, n, 0.05)
    out = {"ring/s": np.eye(n, dtype=np.float32) - a * 0.1,
           "ring/x": rng.random((n, 64)).astype(np.float32)}
    for k in (1, 2):
        adj = _random_graph(rng, 128, 0.08)
        deg = adj.sum(1)
        out[f"gcn{k}/adj"] = adj
        out[f"gcn{k}/dis"] = np.where(deg > 0, 1.0 / np.sqrt(
            np.maximum(deg, 1e-30)), 0.0).astype(np.float32)
        out[f"gcn{k}/x"] = np.ones((128, 1), np.float32)
        for li, (fi, fo) in enumerate(((1, 8), (8, 1))):
            for j in range(k + 1):
                out[f"gcn{k}/{li}/w_{j}"] = rng.standard_normal(
                    (fi, fo)).astype(np.float32)
    out["lgs/adj"] = _random_graph(rng, 128, 0.06)
    out["lgs/w"] = (np.round(rng.random(128) * 4) / 4).astype(np.float32)
    # the batch of the sharded solve: 8 graphs of 20..59 nodes, padded 64
    adjs, wtss = [], []
    for _ in range(8):
        m = int(rng.integers(20, 60))
        adjs.append(sp.csr_matrix(_random_graph(rng, m, 0.1)))
        wtss.append(rng.random(m))
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=64, device="cpu")
    out["mesh/adj"] = gb.adj.numpy()
    out["mesh/wts"] = gb.wts.numpy()
    out["mesh/mask"] = gb.mask.numpy()
    return out


def _gcn_params(inputs, k):
    return [{f"w_{j}": inputs[f"gcn{k}/{li}/w_{j}"] for j in range(k + 1)}
            for li in range(2)]


def mesh_params() -> dict:
    """A Flax `ChebGCN.init` of the JAX package's gcn_dqn model at
    MESH_CFG, flattened to ``mesh/p/<layer>/<leaf>`` arrays."""
    import jax
    import jax.numpy as jnp
    from distgcn_tpu.models.gcn import make_model_from_config as jax_model
    from distgcn_tpu.utils.config import Config as JConfig
    params = jax_model(JConfig(**MESH_CFG), "gcn_dqn").init(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 1)),
        jnp.zeros((1, 2, 64, 64)))["params"]
    return {f"mesh/p/{layer}/{leaf}": np.asarray(v, np.float32)
            for layer, leaves in params.items() for leaf, v in leaves.items()}


def mesh_tree(inputs) -> dict:
    tree = {}
    for key, v in inputs.items():
        if key.startswith("mesh/p/"):
            _, _, layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = v
    return tree


def mesh_model(inputs):
    return make_model_from_config(Config(**MESH_CFG), "gcn_dqn",
                                  params=params_from_jax(mesh_tree(inputs)),
                                  device="cpu")


def run_port(inputs: dict, rank: int, world: int) -> dict:
    """Everything the port computes on this rank's slab; slabs under
    ``slab/``, all-gathered results under ``all/``."""
    out = {}

    def local(name):
        return distributed.host_to_local(inputs[name], rank, world, "cpu")

    def keep(name, t):
        out[f"slab/{name}"] = t.numpy()
        out[f"all/{name}"] = distributed.gather_global(t).numpy()

    for name in [k for k in inputs if k.startswith("ranks/")]:
        keep(name, distributed_lgs_ranks(local(name)))
    n, f = inputs["ring/x"].shape
    keep("ring", make_ring_spmm(n, f)(local("ring/s"), local("ring/x")))
    for k in (1, 2):
        fwd = make_sharded_gcn_forward(128, 1, _gcn_params(inputs, k),
                                       max_degree=k)
        keep(f"gcn{k}", fwd(local(f"gcn{k}/adj"),
                            torch.from_numpy(inputs[f"gcn{k}/dis"]),
                            local(f"gcn{k}/x")))
    sel, util = make_sharded_lgs(128)(
        local("lgs/adj"), local("lgs/w"),
        torch.ones(128 // world, dtype=torch.bool))
    keep("lgs/sel", sel)
    out["lgs/util"] = util.numpy()
    solve = make_sharded_solve(mesh_model(inputs), Config(**MESH_CFG),
                               device="cpu")
    for name, t in zip(("sel", "util", "gutil"), solve(
            *(torch.from_numpy(inputs[f"mesh/{k}"])
              for k in ("adj", "wts", "mask")))):
        out[f"mesh/{name}"] = t.numpy()
    return out


# ---------------------------------------------------------------------------
# module fixtures: the port at D = 1, 2, 4 and JAX at D = 8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    inp = {**rank_inputs(), **dense_inputs(), **mesh_params()}
    path = tmp_path_factory.mktemp("sharded")
    np.savez(path / "inputs.npz", **inp)
    return path, inp


@pytest.fixture(scope="module")
def port(inputs):
    path, inp = inputs
    results = {1: [run_port(inp, 0, 1)]}
    results.update(run_worlds(__file__, path))
    return results


@pytest.fixture(scope="module")
def jax_ref(inputs):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from distgcn_tpu.models.gcn import make_model_from_config as jax_model
    from distgcn_tpu.ops.lgs import lgs_ranks as jax_lgs_ranks
    from distgcn_tpu.parallel import halo as H
    from distgcn_tpu.parallel import mesh as M
    from distgcn_tpu.utils.config import Config as JConfig

    _, inp = inputs
    mesh = Mesh(np.asarray(jax.devices()[:8]), (H.AXIS,))
    out = {}
    ranks = jax.jit(shard_map(lambda w: H.distributed_lgs_ranks(w, 8),
                              mesh=mesh, in_specs=P(H.AXIS),
                              out_specs=P(H.AXIS)))
    for name in [k for k in inp if k.startswith("ranks/")]:
        out[name] = np.asarray(ranks(jnp.asarray(inp[name])))
        out[f"{name}/lgs_ranks"] = np.asarray(
            jax_lgs_ranks(jnp.asarray(inp[name][None])))[0]
    rows = NamedSharding(mesh, P(H.AXIS, None))
    rep = NamedSharding(mesh, P())
    vec = NamedSharding(mesh, P(H.AXIS))
    n, f = inp["ring/x"].shape
    with mesh:
        out["ring"] = np.asarray(H.make_ring_spmm(mesh, n, f)(
            jax.device_put(inp["ring/s"], rows),
            jax.device_put(inp["ring/x"], rows)))
        for k in (1, 2):
            fwd = H.make_sharded_gcn_forward(mesh, 128, 1,
                                             _gcn_params(inp, k),
                                             max_degree=k)
            out[f"gcn{k}"] = np.asarray(fwd(
                jax.device_put(inp[f"gcn{k}/adj"], rows),
                jax.device_put(inp[f"gcn{k}/dis"], rep),
                jax.device_put(inp[f"gcn{k}/x"], rows)))
        sel, util = H.make_sharded_lgs(mesh, 128)(
            jax.device_put(inp["lgs/adj"], rows),
            jax.device_put(inp["lgs/w"], vec),
            jax.device_put(np.ones(128, bool), vec))
    out["lgs/sel"] = np.asarray(sel)
    out["lgs/util"] = float(np.asarray(util)[0])
    jcfg = JConfig(**MESH_CFG)
    solve = M.make_sharded_solve(jax_model(jcfg, "gcn_dqn"), jcfg,
                                 M.make_mesh(devices=jax.devices()[:8]))
    for name, t in zip(("sel", "util", "gutil"), solve(
            mesh_tree(inp), *(jnp.asarray(inp[f"mesh/{k}"])
                              for k in ("adj", "wts", "mask")))):
        out[f"mesh/{name}"] = np.asarray(t)
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

RANK_CASES = ("ties0", "ties1", "equal", "signed_zeros")


@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("case", RANK_CASES)
def test_distributed_lgs_ranks_match_jax(port, jax_ref, inputs, world, case):
    name = f"ranks/{case}"
    w = inputs[1][name]
    got = port[world][0][f"all/{name}"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_ref[name])
    np.testing.assert_array_equal(got, jax_ref[f"{name}/lgs_ranks"])
    np.testing.assert_array_equal(got, lgs_ranks(torch.from_numpy(w)))
    if case == "equal":      # ascending id wins: rank n for id 0
        np.testing.assert_array_equal(got, np.arange(w.size, 0, -1))


def test_signed_zeros_order_by_id():
    """+0.0 and -0.0 are one weight: their order is the ids', as in the
    JAX package's sorts."""
    w = torch.tensor([0.0, -0.0, 0.0, -0.0, 0.5, -0.5, -0.0, 0.0])
    np.testing.assert_array_equal(distributed_lgs_ranks(w),
                                  [7, 6, 5, 4, 8, 1, 3, 2])


@pytest.mark.parametrize("world", WORLDS)
def test_gather_global_concatenates_every_rank(port, world):
    for key in port[world][0]:
        if not key.startswith("slab/"):
            continue
        slabs = np.concatenate([r[key] for r in port[world]])
        for r in port[world]:
            np.testing.assert_array_equal(r["all/" + key[5:]], slabs)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_ring_spmm_matches_jax_and_dense(port, jax_ref, inputs, world):
    inp = inputs[1]
    got = port[world][0]["all/ring"]
    np.testing.assert_allclose(got, jax_ref["ring"], atol=1e-3)
    np.testing.assert_allclose(got, inp["ring/s"] @ inp["ring/x"],
                               atol=1e-3)


@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("k,atol", [(1, 2e-3), (2, 5e-3)])
def test_sharded_gcn_forward_matches_jax(port, jax_ref, world, k, atol):
    got = port[world][0][f"all/gcn{k}"]
    assert got.shape == jax_ref[f"gcn{k}"].shape == (128, 1)
    np.testing.assert_allclose(got, jax_ref[f"gcn{k}"], atol=atol)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_sharded_lgs_matches_jax(port, jax_ref, world):
    got = port[world][0]
    np.testing.assert_array_equal(got["all/lgs/sel"], jax_ref["lgs/sel"])
    assert float(got["lgs/util"]) == pytest.approx(jax_ref["lgs/util"],
                                                   rel=1e-6)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_sharded_solve_matches_jax(port, jax_ref, world):
    """The port's gathered batch solve against JAX's `make_sharded_solve`
    on an 8-way ``data`` mesh, one Flax init on both sides."""
    assert jax_ref["mesh/sel"].shape == (8, 64)
    for r in port[world]:
        np.testing.assert_array_equal(r["mesh/sel"], jax_ref["mesh/sel"])
        for name in ("util", "gutil"):
            np.testing.assert_allclose(r[f"mesh/{name}"],
                                       jax_ref[f"mesh/{name}"], rtol=1e-5)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_sharded_solve_equals_single_process_pipeline(port, inputs, world):
    inp = inputs[1]
    want = make_solve_pipeline(mesh_model(inp), Config(**MESH_CFG))(
        *(torch.from_numpy(inp[f"mesh/{k}"]) for k in ("adj", "wts", "mask")))
    for r in port[world]:
        for name, t in zip(("sel", "util", "gutil"), want):
            np.testing.assert_array_equal(r[f"mesh/{name}"], t.numpy())


def test_initialize_without_env_is_a_one_rank_ring(monkeypatch):
    for var in ("DISTGCN_COORDINATOR", "DISTGCN_NUM_PROCESSES",
                "DISTGCN_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.process_info() == (0, 1, 1, 1)
    monkeypatch.setenv("DISTGCN_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="together"):
        distributed.initialize(device="cpu")
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(
        distributed.host_to_local(x, 2, 3, "cpu"), x[4:6])
    with pytest.raises(ValueError, match="equal slabs"):
        distributed.host_to_local(x, 0, 4, "cpu")


def test_i32_nbr_max_plain_bit_equal_to_jax_interpret():
    """`tests/test_distributed_ranks.py`'s input (x up to 2^28, beyond
    f32's integers), on the JAX package's own padded block arrays and on
    the port's."""
    import jax.numpy as jnp
    from distgcn_tpu.ops import spmm as S
    rng = np.random.default_rng(3)
    a = sp.random(384, 384, 0.04, random_state=4, format="csr")
    a = ((a + a.T) > 0).astype(np.float32)
    a.setdiag(0)
    a.eliminate_zeros()
    jb = S.BsrMatrix.from_scipy(a, 128, dtype=np.int8)
    jrp = S.bsr_row_ptr(jb)
    x = rng.integers(-5, 1 << 28, 384).astype(np.int32)
    want = np.asarray(S._bsr_nbr_max_rows_i32(
        jb.blk_vals, jrp, jb.blk_cols, jnp.asarray(x), jb.n_rows, 128,
        interpret=True))
    got = bsr_nbr_max_plain(
        torch.from_numpy(np.array(jb.blk_vals)),
        torch.from_numpy(np.array(jrp)),
        torch.from_numpy(np.array(jb.blk_cols)), torch.from_numpy(x),
        jb.n_rows, 128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    b = BsrMatrix.from_scipy(a, 128, dtype=np.int8, device="cpu")
    np.testing.assert_array_equal(
        bsr_neighbor_max(b, torch.from_numpy(x)).numpy(), want)
    oracle = np.where(a.toarray() != 0, x[None, :], I32_SENT).max(1)
    np.testing.assert_array_equal(want[:384], oracle)


def test_i32_nbr_max_plain_bitmap_empty_block_row_bit_equal_to_jax():
    """Bitmap blocks at bs=32 with an empty block-row, payloads spanning
    -1, 2^24 + 1 and 2^31 - 2."""
    import jax.numpy as jnp
    from distgcn_tpu.ops import spmm as S
    rng = np.random.default_rng(5)
    n = 256
    a = sp.random(n, n, 0.05, random_state=6, format="lil")
    a[64:96, :] = 0                       # block-row 2 has no block
    a = sp.csr_matrix(a)
    a.data[:] = 1.0
    a.eliminate_zeros()
    x = rng.choice(np.array([-1, 1 << 24, (1 << 24) + 1, 2 ** 31 - 2,
                             2 ** 31 - 3], np.int32), n)
    jb = S.BsrMatrix.from_scipy(a, 32, dtype=np.int8)
    want = np.asarray(S._bsr_nbr_max_rows_i32(
        S.pack_bits_blocks(np.asarray(jb.blk_vals)), S.bsr_row_ptr(jb),
        jb.blk_cols, jnp.asarray(x), jb.n_rows, 32, interpret=True,
        bitmap=True))
    b = BsrMatrix.from_scipy(a, 32, dtype="bits", device="cpu")
    got = bsr_neighbor_max(b, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[64:96] == I32_SENT).all()
    # the raw-array dispatch reads only the blocks row_ptr addresses
    rp = bsr_row_ptr(b)
    pad = torch.zeros((3,) + tuple(b.blk_vals.shape[1:]), dtype=torch.int32)
    np.testing.assert_array_equal(nbr_max_rows(
        torch.cat([b.blk_vals, pad - 1]), rp,
        torch.cat([b.blk_cols, torch.zeros(3, dtype=torch.int32)]),
        torch.from_numpy(x), n, 32, bitmap=True).numpy(), want)


def test_i32_kernel_wrapper_never_falls_back_and_checks_the_payload():
    from distgcn_tpu_torch.ops.nbr_max_cuda import bsr_nbr_max_i32_kernel
    a = sp.random(256, 256, 0.05, random_state=1, format="csr")
    a.data[:] = 1.0
    b = BsrMatrix.from_scipy(a, 128, dtype="bits", device="cpu")
    rp = bsr_row_ptr(b)
    before = bsr_nbr_max_i32_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        bsr_nbr_max_i32_kernel(b.blk_vals, rp, b.blk_cols,
                               torch.zeros(256, dtype=torch.int32), 256, 128,
                               True)
    with pytest.raises(ValueError, match="1-D int32"):
        bsr_nbr_max_i32_kernel(b.blk_vals, rp, b.blk_cols, torch.zeros(256),
                               256, 128, True)
    assert bsr_nbr_max_i32_kernel.launches == before
    with pytest.raises(ValueError, match="f32 or int32"):
        bsr_nbr_max_plain(b.blk_vals, rp, b.blk_cols,
                          torch.zeros(256, dtype=torch.int64), 256, 128, True)


if __name__ == "__main__":
    worker_main(run_port)
