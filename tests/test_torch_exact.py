"""Port parity: the exact MWIS solvers, the LP relaxations and the host
CLIs that use them (`gen_data`, `benchmark_solver`) against the JAX
package on the same inputs.

The port builds its own copy of the native source; selections of the
native and host solvers are held bit-equal and utilities equal (exact
utilities to rtol 1e-9). Graphs are small enough to be proven optimal, so
the native solver's wall-clock timeout never decides a result.
"""

import itertools
import os

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from conftest import random_graph
from distgcn_tpu.cli import benchmark_solver as jbench
from distgcn_tpu.cli import gen_data as jgen
from distgcn_tpu.data import generate as jgenerate
from distgcn_tpu.data import matio as jmatio
from distgcn_tpu.solvers import exact as jexact
from distgcn_tpu.solvers import relax as jrelax
from distgcn_tpu_torch.cli import benchmark_solver, gen_data
from distgcn_tpu_torch.data import generate, matio
from distgcn_tpu_torch.solvers import exact, relax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_EXACT = 1e-9          # exact utilities (float64 sums in both)


def _graphs(seed, k, n, p):
    rng = np.random.default_rng(seed)
    return [(random_graph(rng, n, p), rng.random(n)) for _ in range(k)]


def _brute_force(adj, w):
    a = sp.csr_matrix(adj)
    n = w.size
    nbrs = [set(a.indices[a.indptr[v]: a.indptr[v + 1]]) for v in range(n)]
    best = 0.0
    for r in range(n + 1):
        for c in itertools.combinations(range(n), r):
            if any(nbrs[v] & set(c) for v in c):
                continue
            best = max(best, w[list(c)].sum())
    return best


def _independent(adj, sel) -> bool:
    ii = sorted(int(v) for v in sel)
    return sp.csr_matrix(adj)[ii][:, ii].nnz == 0


def test_native_library_is_the_ports_own_copy():
    path = os.path.realpath(exact.native_library())
    native = os.path.join(REPO, "distgcn_tpu", "native")
    assert not path.startswith(native + os.sep), path
    assert path.startswith(os.path.join(REPO, "build", "native") + os.sep)
    assert os.path.basename(path).startswith("libmwis_exact-")
    with open(exact.SRC) as f, \
            open(os.path.join(native, "mwis_exact.cpp")) as g:
        ours, theirs = f.read(), g.read()
    # the same solver: the copy differs only in its header comment
    assert ours.split("#include", 1)[1] == theirs.split("#include", 1)[1]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises."""
    bad = tmp_path / "mwis_exact.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(exact, "SRC", bad)
    monkeypatch.setattr(exact, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(exact, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        exact.mwis_exact(np.zeros((2, 2)), np.ones(2), 1.0)
    with pytest.raises(RuntimeError, match="failed"):
        exact.fast_greedy(np.zeros((2, 2)), np.ones(2))
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("n,p", [(12, 0.3), (16, 0.2)])
def test_mwis_exact_matches_brute_force(n, p):
    for a, w in _graphs(n, 10, n, p):
        solu, val, status = exact.mwis_exact(a, w, 10.0)
        assert status == "Optimal"
        assert _independent(a, solu)
        np.testing.assert_allclose(val, _brute_force(a, w), rtol=RTOL_EXACT)


@pytest.mark.parametrize("n,p,ties", [(30, 0.12, False), (36, 0.1, True),
                                      (60, 0.08, False), (100, 0.04, False)])
def test_native_solvers_match_jax(n, p, ties):
    """mwis_exact (cold and warm-started), fast_greedy and
    fast_local_greedy: bit-equal selections and equal utilities. Engineered
    ties only below 40 nodes: from 40 live nodes on, the native B&B spends
    a share of its timeout on a local search, and which of several optima
    it returns could then depend on the clock."""
    for a, w in _graphs(n + int(ties), 3, n, p):
        if ties:
            w = np.round(w * 8) / 8
        got, want = exact.mwis_exact(a, w, 5.0), jexact.mwis_exact(a, w, 5.0)
        assert want[2] == "Optimal" and got[2] == want[2]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        init = np.zeros(n, np.int8)
        init[list(jexact.fast_greedy(a, w)[0])] = 1
        got = exact.mwis_exact(a, w, 5.0, init_sel=init)
        want = jexact.mwis_exact(a, w, 5.0, init_sel=init)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL_EXACT)
        for name in ("fast_greedy", "fast_local_greedy"):
            gs, gv = getattr(exact, name)(a, w)
            ws, wv = getattr(jexact, name)(a, w)
            assert gs == ws and gv == wv, name


@pytest.mark.parametrize("n,p", [(14, 0.25), (30, 0.15), (36, 0.12)])
def test_python_bnb_matches_jax_and_native(n, p):
    for a, w in _graphs(100 + n, 3, n, p):
        a64, w64 = exact._csr(a), w.astype(np.float64)
        got = exact._python_bnb(a64, w64, 60.0)
        want = jexact._python_bnb(jexact._csr(a), w64, 60.0)
        assert got[2] == want[2] == "Optimal"
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_allclose(got[1], exact.mwis_exact(a, w, 30.0)[1],
                                   rtol=RTOL_EXACT)


@pytest.mark.parametrize("n,p", [(10, 0.3), (14, 0.25)])
def test_all_maximal_is_and_get_mwis_match_jax(n, p):
    for a, w in _graphs(200 + n, 3, n, p):
        got = exact.all_maximal_is(a)
        assert got == jexact.all_maximal_is(a)
        dense = a.toarray()
        for mis in got:
            assert not dense[np.ix_(mis, mis)].any()
            outside = np.setdiff1d(np.arange(n), mis)
            assert dense[np.ix_(outside, mis)].any(axis=1).all()
        w = w + 0.1
        gs, gv = exact.get_mwis(a, w)
        ws, wv = jexact.get_mwis(a, w)
        assert gs == ws and gv == wv
        np.testing.assert_allclose(gv, exact.mwis_exact(a, w, 10.0)[1],
                                   rtol=RTOL_EXACT)


def test_empty_and_trivial_graphs():
    w = np.array([1.0, 2.0, 3.0, 4.0])
    solu, val, status = exact.mwis_exact(sp.csr_matrix((4, 4)), w, 5.0)
    assert status == "Optimal" and val == 10.0
    np.testing.assert_array_equal(solu, [0, 1, 2, 3])
    edge = sp.csr_matrix(np.array([[0, 1], [1, 0]], float))
    solu, val, _ = exact.mwis_exact(edge, np.array([1.0, 5.0]), 5.0)
    assert solu.tolist() == [1] and val == 5.0
    assert exact.mlp_gurobi is exact.mwis_exact


@pytest.mark.parametrize("n,p", [(30, 0.15), (60, 0.1)])
def test_milp_matches_jax_and_native(n, p):
    for a, w in _graphs(300 + n, 2, n, p):
        got, want = exact.mwis_milp(a, w, 30.0), jexact.mwis_milp(a, w, 30.0)
        assert got[2] == want[2] == "Optimal"
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], exact.mwis_exact(a, w, 30.0)[1],
                                   rtol=RTOL_EXACT)
    assert exact._milp_status(4) == jexact._milp_status(4) == "Failed(4)"


def test_root_duals_dual_bnb_and_cut_match_jax():
    """The cutting-plane LP's certificate, the dual-pool B&B and the
    cutting-plane MILP on graphs with odd cycles to separate."""
    for a, w in _graphs(400, 2, 50, 0.12):
        got = exact.mwis_root_duals(a, w, time_budget=60.0)
        want = jexact.mwis_root_duals(a, w, time_budget=60.0)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(x))
        opt = exact.mwis_exact(a, w, 30.0)[1]
        assert got[4] >= opt - 1e-9          # a proven upper bound
        sel, val, status = exact.mwis_exact_dual(a, w, 30.0, got)
        jsel, jval, jstatus = jexact.mwis_exact_dual(a, w, 30.0, want)
        assert status == jstatus == "Optimal"
        np.testing.assert_array_equal(sel, jsel)
        np.testing.assert_allclose(val, opt, rtol=RTOL_EXACT)
        assert val == jval
        cut = exact.mwis_cut(a, w, 60.0, incumbent=opt * 0.9)
        jcut = jexact.mwis_cut(a, w, 60.0, incumbent=opt * 0.9)
        assert cut[2] == jcut[2] == "Optimal"
        np.testing.assert_array_equal(cut[0], jcut[0])
        np.testing.assert_allclose(cut[1], opt, rtol=RTOL_EXACT)


@pytest.mark.parametrize("timeout", [60.0, 600.0])
def test_prove_matches_jax(timeout):
    for a, w in _graphs(500, 2, 16, 0.25):
        got = exact.mwis_prove(a, w, timeout)
        want = jexact.mwis_prove(a, w, timeout)
        assert got[2] == want[2] == "Optimal"
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], _brute_force(a, w),
                                   rtol=RTOL_EXACT)


def test_maximal_cliques_in_networkx_order():
    import networkx as nx
    rng = np.random.default_rng(7)
    for _ in range(40):
        n = int(rng.integers(1, 60))
        a = random_graph(rng, n, float(rng.random()) * 0.4)
        want = list(nx.algorithms.clique.find_cliques(
            nx.from_scipy_sparse_array(a)))
        assert relax.maximal_cliques(a) == want


@pytest.mark.parametrize("n,p", [(35, 0.15), (50, 0.1)])
def test_relaxations_match_jax(n, p):
    for a, w in _graphs(600 + n, 2, n, p):
        np.testing.assert_array_equal(relax.mwis_lp_edge_relax(a, w),
                                      jrelax.mwis_lp_edge_relax(a, w))
        np.testing.assert_array_equal(relax.mwis_lp_clique_relax(a, w),
                                      jrelax.mwis_lp_clique_relax(a, w))
        gs, gv = relax.mp_greedy(a, w)
        ws, wv = jrelax.mp_greedy(a, w)
        assert gs == ws and gv == wv
        assert _independent(a, gs)
        keep = np.nonzero(np.asarray(a.sum(1)).flatten() > 0)[0]
        a2 = sp.csr_matrix(a.toarray()[np.ix_(keep, keep)])
        got = relax.mwis_lp_edge_dual(a2, w[keep])
        want = jrelax.mwis_lp_edge_dual(a2, w[keep])
        assert (got != want).nnz == 0


def test_label_instance_exact_matches_jax():
    for a, w in _graphs(700, 3, 25, 0.15):
        w = w + 0.1
        got = generate.label_instance(a, w, exact=True)
        want = jgenerate.label_instance(a, w, exact=True)
        assert got == want
        assert _independent(a, got[0])
        heur = generate.label_instance(a, w, rng=np.random.default_rng(0))
        assert got[1] >= heur[1] - 1e-9


def _same_mat(path_a, path_b):
    ma, mb = sio.loadmat(path_a), sio.loadmat(path_b)
    keys = {k for k in ma if not k.startswith("__")}
    assert keys == {k for k in mb if not k.startswith("__")}
    for k in keys:
        if sp.issparse(ma[k]):
            assert (ma[k] != mb[k]).nnz == 0
        elif ma[k].dtype.names:          # the wireless gdict struct
            for f in ma[k].dtype.names:
                np.testing.assert_array_equal(ma[k][f][0, 0], mb[k][f][0, 0])
        else:
            np.testing.assert_array_equal(ma[k], mb[k])


@pytest.mark.parametrize("argv", [
    ["--type=ER", "--sizes=20,30", "--ps=0.2", "--n=2", "--seed=1"],
    ["--type=BA", "--sizes=25", "--ps=0.1", "--n=2", "--seed=3",
     "--no_label"],
    ["--type=ER", "--sizes=40", "--nbs=4,8", "--n=1", "--seed=5"],
    ["--wireless", "--n=2", "--seed=11"]])
def test_gen_data_matches_jax_and_loads_in_both(tmp_path, argv):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    n = gen_data.main([f"--datapath={ours}", *argv])
    assert n == jgen.main([f"--datapath={theirs}", *argv]) and n > 0
    files = sorted(os.listdir(ours))
    assert files == sorted(os.listdir(theirs)) and len(files) == n
    for f in files:
        _same_mat(ours / f, theirs / f)
        if "--wireless" in argv:
            continue
        for load in (matio.load_mat, jmatio.load_mat):
            inst = load(str(ours / f))
            assert inst.adj.shape[0] == inst.weights.size
            if "--no_label" not in argv:
                assert inst.mwis_utility >= inst.greedy_utility - 1e-9


def test_benchmark_solver_matches_jax_and_resumes_across(tmp_path):
    """Both packages sweep the same dataset: equal p and status; a CSV one
    package wrote resumes under the other with no row re-solved; shards
    merge as in the JAX package."""
    data = tmp_path / "g"
    gen_data.main([f"--datapath={data}", "--type=ER", "--sizes=25,30",
                   "--ps=0.15", "--n=2", "--seed=2", "--no_label"])
    argv = [f"--datapath={data}", "--solver=optimal", "--timeout=5"]
    rows = benchmark_solver.main(argv + [f"--output_dir={tmp_path / 'p'}"])
    df = jbench.main(argv + [f"--output_dir={tmp_path / 'j'}"])
    assert [r["data"] for r in rows] == df["data"].tolist()
    assert [r["status"] for r in rows] == ["Optimal"] * 4
    assert df["status"].tolist() == ["Optimal"] * 4
    np.testing.assert_allclose([r["p"] for r in rows], df["p"].to_numpy(),
                               rtol=RTOL_EXACT)
    assert all(r["p"] >= 1.0 - 1e-9 for r in rows)
    csv_name = "mwis_exact_g.csv"
    # the JAX CSV resumes under the port, and the reverse: nothing re-run
    again = benchmark_solver.main(argv + [f"--output_dir={tmp_path / 'j'}"])
    assert [r["runtime"] for r in again] == df["runtime"].tolist()
    jagain = jbench.main(argv + [f"--output_dir={tmp_path / 'p'}"])
    # pandas' default float parser may miss the last bit; a re-solved row
    # would carry a new runtime altogether
    np.testing.assert_allclose(jagain["runtime"].to_numpy(),
                               [r["runtime"] for r in rows], rtol=1e-12)
    assert (tmp_path / "p" / csv_name).exists()
    # a p == 0 row is tried again, a shard fills it and merges back
    table = benchmark_solver.read_table(str(tmp_path / "p" / csv_name))
    table[1].update(p=0.0, status="Timeout")
    benchmark_solver.write_table(str(tmp_path / "p" / csv_name), table)
    out = f"--output_dir={tmp_path / 'p'}"
    shard = benchmark_solver.main(argv + [out, "--shard=1/2"])
    assert shard[1]["status"] == "Optimal" and shard[0] == table[0]
    merged = benchmark_solver.main(argv + [out, "--merge_shards=2"])
    np.testing.assert_allclose([r["p"] for r in merged],
                               [r["p"] for r in rows], rtol=RTOL_EXACT)


@pytest.mark.parametrize("solver", ["milp", "heuristic"])
def test_benchmark_solver_other_solvers_match_jax(tmp_path, solver):
    data = tmp_path / "g"
    gen_data.main([f"--datapath={data}", "--type=ER", "--sizes=20",
                   "--ps=0.2", "--n=2", "--seed=4", "--no_label"])
    argv = [f"--datapath={data}", f"--solver={solver}", "--timeout=20"]
    rows = benchmark_solver.main(argv + [f"--output_dir={tmp_path / 'p'}"])
    df = jbench.main(argv + [f"--output_dir={tmp_path / 'j'}"])
    assert [r["status"] for r in rows] == df["status"].tolist()
    np.testing.assert_allclose([r["p"] for r in rows], df["p"].to_numpy(),
                               rtol=RTOL_EXACT)
