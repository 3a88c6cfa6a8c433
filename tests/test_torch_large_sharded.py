"""Port parity: the sharded giant-graph solve (`parallel/large_sharded.py`)
against the JAX package's on its 8 virtual CPU devices (Pallas in
interpret mode), on the inputs of `tests/test_large_sharded.py`.

The host builder must be array-for-array equal to JAX's. The port's solve
runs as a one-rank ring in this process and as 2 and 4 gloo processes
(this file is also the worker; see `tests/test_torch_sharded.py`);
selections on the real nodes must equal JAX's at D=8 and utilities agree
within rtol 1e-5 (`tests/test_large_sharded.py:54`).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.large import geometric_conflict_graph, params_to_list
from distgcn_tpu_torch.ops.spmm import edge_values
from distgcn_tpu_torch.parallel import distributed
from distgcn_tpu_torch.parallel.large_sharded import (make_sharded_large_solve,
                                                      shard_arrays,
                                                      shard_large_graph)
from test_torch_sharded import WORLDS, run_worlds, worker_main

# graph (n, average degree, seed), block size, weighted, model
CASES = {
    "flax3": (400, 10.0, 21, 8, False, "flax"),
    "bitmap": (700, 9.0, 61, 32, False, "fixed"),
    "int8": (700, 9.0, 61, 8, False, "fixed"),
    "weighted": (300, 8.0, 41, 8, True, "fixed_w"),
    "weighted_bits": (300, 8.0, 41, 32, True, "fixed_w"),
    "bias_only": (300, 8.0, 22, 8, False, "bias"),
}
FIXED = {"fixed": (0.3, 0.9, 0.05), "fixed_w": (0.4, 0.7, 0.2),
         "bias": (0.0, 0.0, 1.0)}


def case_graph(name):
    n, deg, seed, _, weighted, _ = CASES[name]
    adj, wts, _ = geometric_conflict_graph(n, avg_degree=deg, seed=seed)
    if weighted:
        rng = np.random.default_rng(7)
        a = sp.triu(sp.csr_matrix(adj), 1).tocoo()
        a.data = rng.uniform(0.5, 2.0, a.nnz).astype(np.float32)
        adj = (a + a.T).tocsr()
    return adj, wts


def _tree(inputs, name):
    tree = {}
    for key, v in inputs.items():
        parts = key.split("/")
        if parts[0] == name and parts[1] == "p":
            tree.setdefault(parts[2], {})[parts[3]] = v
    return tree


def run_port(inputs: dict, rank: int, world: int) -> dict:
    out = {}
    for name, (n, _, _, bs, _, _) in CASES.items():
        adj = sp.csr_matrix((inputs[f"{name}/data"], inputs[f"{name}/indices"],
                             inputs[f"{name}/indptr"]), shape=(n, n))
        sg = shard_large_graph(adj, world, block_size=bs)
        a1, a2, a3, a4, mask = shard_arrays(sg, device="cpu")
        w = np.zeros(sg.n_pad, np.float32)
        w[:n] = inputs[f"{name}/wts"]
        solve = make_sharded_large_solve(sg, device="cpu")
        sel, util = solve(a1, a2, a3, a4,
                          params_to_list(_tree(inputs, name), device="cpu"),
                          distributed.host_to_local(w, rank, world, "cpu"),
                          mask)
        out[f"{name}/sel"] = distributed.gather_global(sel).numpy()[:n]
        out[f"{name}/util"] = util.numpy()
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from distgcn_tpu.models.gcn import ChebGCN
    inp = {}
    for name, (_, _, _, _, _, model) in CASES.items():
        adj, wts = case_graph(name)
        inp.update({f"{name}/data": adj.data, f"{name}/indices": adj.indices,
                    f"{name}/indptr": adj.indptr, f"{name}/wts": wts})
        if model == "flax":
            params = ChebGCN(num_layer=3, hidden_dim=16, out_dim=1,
                             num_supports=2).init(
                jax.random.PRNGKey(3), jnp.zeros((1, 8, 1)),
                jnp.zeros((1, 2, 8, 8)))["params"]
            tree = jax.tree_util.tree_map(np.asarray, params)
        else:
            w0, w1, b = FIXED[model]
            tree = {"gc1": {"w_0": np.full((1, 1), w0, np.float32),
                            "w_1": np.full((1, 1), w1, np.float32),
                            "bias": np.full((1,), b, np.float32)}}
        for layer, leaves in tree.items():
            for leaf, v in leaves.items():
                inp[f"{name}/p/{layer}/{leaf}"] = np.asarray(v, np.float32)
    path = tmp_path_factory.mktemp("large_sharded")
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
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from distgcn_tpu import large as J
    from distgcn_tpu.parallel import large_sharded as JS
    from distgcn_tpu.solvers.greedy import local_greedy_search

    _, inp = inputs
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("graph",))
    out = {}
    for name, (n, _, _, bs, _, _) in CASES.items():
        adj, wts = case_graph(name)
        sg = JS.shard_large_graph(adj, 8, block_size=bs, interpret=True)
        a1, a2, a3, a4, mask = JS.shard_arrays(mesh, sg)
        w = np.zeros(sg.n_pad, np.float32)
        w[:n] = wts
        sel, util = JS.make_sharded_large_solve(mesh, sg)(
            a1, a2, a3, a4, J.params_to_list(_tree(inp, name)),
            jax.device_put(jnp.asarray(w), NamedSharding(mesh, P("graph"))),
            mask)
        out[f"{name}/sel"] = np.asarray(sel)[:n]
        out[f"{name}/util"] = float(np.asarray(util)[0])
    out["bias_only/greedy"] = local_greedy_search(*case_graph("bias_only"))
    return out


@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_large_solve_matches_jax(port, jax_ref, world, name):
    for r in port[world]:
        np.testing.assert_array_equal(r[f"{name}/sel"],
                                      jax_ref[f"{name}/sel"])
        np.testing.assert_allclose(float(r[f"{name}/util"]),
                                   jax_ref[f"{name}/util"], rtol=1e-5)
    sel = port[world][0][f"{name}/sel"]
    assert not (sel == -1).any()
    if name == "bitmap":       # the same 0/1 operand as the int8 stream
        np.testing.assert_array_equal(sel, port[world][0]["int8/sel"])
    if name == "weighted_bits":   # edge values on bitmap or int8 panels
        np.testing.assert_array_equal(sel, port[world][0]["weighted/sel"])
    if name == "bias_only":    # scores == weights: plain LGS
        ref_set, ref_util = jax_ref["bias_only/greedy"]
        assert set(np.flatnonzero(sel == 1).tolist()) == ref_set
        assert float(port[world][0]["bias_only/util"]) == pytest.approx(
            ref_util, rel=1e-5)


BUILDER_CASES = {
    "int8_d8": ("flax3", 8, 8),
    "bitmap_d8": ("bitmap", 8, 32),
    "bitmap_d4_bs64": (None, 4, 64),
    "weighted_d8": ("weighted", 8, 8),
    "weighted_d2_bs32": ("weighted", 2, 32),
}


@pytest.mark.parametrize("case", sorted(BUILDER_CASES))
def test_shard_large_graph_matches_jax(case):
    from distgcn_tpu.parallel.large_sharded import shard_large_graph as jshard
    name, d, bs = BUILDER_CASES[case]
    if name is None:   # test_large_sharded.py's accounting graph
        adj, _, _ = geometric_conflict_graph(2048, avg_degree=16.0, seed=51)
    else:
        adj, _ = case_graph(name)
    got = shard_large_graph(adj, d, block_size=bs)
    want = jshard(adj, d, block_size=bs, interpret=True)
    for field in ("n", "n_pad", "n_loc", "d", "block_size", "nb_max",
                  "bitmap", "separable", "nnz_blocks"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("ind", "rptr", "cols", "mask", "r", "vals"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)
    for f in (0, 128):
        assert got.bytes_per_edge(adj.nnz, f=f, n_layers=3) == \
            want.bytes_per_edge(adj.nnz, f=f, n_layers=3)
    assert (got.evals is None) == (got.eoff is None) == got.separable
    if not got.separable:
        _assert_panel_edges_rebuild(got)


def _assert_panel_edges_rebuild(sg):
    """Each panel's edge form equals the torch builder's rebuild from its
    value panel: words as its structure panel packs them (the panel
    itself when bitmap), values zero past the panel's count."""
    nnz = 0
    for p in range(sg.d * sg.d):
        i, j = divmod(p, sg.d)
        rptr = torch.from_numpy(sg.rptr[i, j])
        want = edge_values(torch.from_numpy(sg.vals[i, j]), rptr)
        words = edge_values(torch.from_numpy(sg.ind[i, j]), rptr).words \
            if not sg.bitmap else torch.from_numpy(sg.ind[i, j])
        np.testing.assert_array_equal(want.words.numpy(), words.numpy())
        np.testing.assert_array_equal(sg.eoff[i, j], want.off.numpy())
        cnt = want.vals.numel()
        np.testing.assert_array_equal(sg.evals[i, j, :cnt],
                                      want.vals.numpy())
        assert not sg.evals[i, j, cnt:].any()
        nnz += cnt
    assert nnz > 0 and sg.evals.shape[2] == max(
        int(sg.eoff[i, j, -1]) for i in range(sg.d) for j in range(sg.d))


def test_shard_arrays_and_solve_reject_a_mismatched_ring():
    adj, _ = case_graph("bias_only")
    sg = shard_large_graph(adj, 2, block_size=8)
    with pytest.raises(ValueError, match="2 ranks"):
        shard_arrays(sg, device="cpu")
    with pytest.raises(ValueError, match="2 ranks"):
        make_sharded_large_solve(sg, device="cpu")
    sg1 = shard_large_graph(adj, 1, block_size=8)
    a = shard_arrays(sg1, device="cpu")
    assert [t.shape for t in a] == [(1, sg1.nb_max, 8, 8),
                                    (1, sg1.n_pad // 8 + 1),
                                    (1, sg1.nb_max), (sg1.n_pad,),
                                    (sg1.n_pad,)]
    assert a[0].dtype == torch.int8 and a[4].dtype == torch.bool


if __name__ == "__main__":
    worker_main(run_port)
