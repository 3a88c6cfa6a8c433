"""Port parity: the large-graph path (`large.py`) against the JAX package's
`distgcn_tpu/large.py` (ELL route, and the Pallas BSR route in interpret
mode) and the host `local_greedy_search`.

Graph builders, LGS selections and round counts are exact and must be
bit-equal. The exact (f32) forward is held to rtol 1e-5 / atol 1e-6
(`tests/test_cheb_fused.py:109`), utilities to rtol 1e-5
(`tests/test_large.py:129`). The CUDA kernels run only on the card
(`tests/test_torch_large_kernels.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distgcn_tpu import large as J
from distgcn_tpu.models.gcn import ChebGCN
from distgcn_tpu.ops.lgs import ell_lgs as jax_ell_lgs
from distgcn_tpu.ops.spmm import BsrMatrix as JBsr
from distgcn_tpu.ops.spmm import bsr_row_ptr as jax_row_ptr
from distgcn_tpu.ops.spmm import pack_bits_blocks
from distgcn_tpu.solvers.greedy import local_greedy_search
from distgcn_tpu_torch import large as T
from distgcn_tpu_torch.models.layers import identity
from distgcn_tpu_torch.ops.cheb_fused import pad_params
from distgcn_tpu_torch.ops.lgs import ell_lgs
from distgcn_tpu_torch.ops.spmm import BsrMatrix, bsr_row_ptr, edge_values
from distgcn_tpu_torch.utils.serialization import load_params

CKPT = "model/result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn/params.npz"


def _flax_params(num_layer, hidden, max_degree=1, seed=0):
    model = ChebGCN(num_layer=num_layer, hidden_dim=hidden, out_dim=1,
                    num_supports=max_degree + 1)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 1)),
                        jnp.zeros((1, max_degree + 1, 8, 8)))["params"]
    return params, jax.tree_util.tree_map(np.asarray, params)


def _wpad(wts, n_pad):
    w = np.zeros(n_pad, np.float32)
    w[: wts.shape[0]] = wts
    return w


def _int8_copy(g, adj):
    """`g` with its structure blocks as an int8 stream (the same blocks)."""
    s = sp.csr_matrix(adj, dtype=np.float32, copy=True)
    s.data[:] = 1.0
    s.resize(g.n_pad, g.n_pad)
    ind = BsrMatrix.from_scipy(s, g.ind_bsr.block_size, dtype=np.int8,
                               device="cpu")
    assert torch.equal(bsr_row_ptr(ind), g.ind_row_ptr)
    return dataclasses.replace(g, ind_bsr=ind, bitmap=False)


@pytest.mark.parametrize("order", ["rcm", "grid", "morton"])
def test_geometric_conflict_graph_matches_jax(order):
    adj, wts, xy = T.geometric_conflict_graph(900, avg_degree=12.0, seed=4,
                                              order=order)
    jadj, jwts, jxy = J.geometric_conflict_graph(900, avg_degree=12.0,
                                                 seed=4, order=order)
    assert (adj != jadj).nnz == 0 and adj.dtype == jadj.dtype
    np.testing.assert_array_equal(wts, jwts)
    np.testing.assert_array_equal(xy, jxy)
    np.testing.assert_array_equal(T.serpentine_order(xy, tile=64),
                                  J.serpentine_order(xy, tile=64))


@pytest.mark.parametrize("weighted", [False, True])
def test_build_large_graph_matches_jax(weighted):
    adj, _, _ = T.geometric_conflict_graph(700, avg_degree=10.0, seed=2)
    if weighted:
        adj = adj.copy()
        adj.data = np.random.default_rng(0).random(adj.nnz).astype(
            np.float32) + 0.5
        adj = (adj + adj.T) * 0.5
    g = T.build_large_graph(adj, block_size=128, use_bsr=True, device="cpu")
    jg = J.build_large_graph(adj, block_size=128, use_pallas=True,
                             interpret=True)
    assert (g.n, g.n_pad, g.nnz, g.separable, g.bitmap) == (
        jg.n, jg.n_pad, jg.nnz, jg.separable, jg.bitmap)
    # each route holds its own arrays: the ELL ones on the ELL route only
    ge = T.build_large_graph(adj, block_size=128, use_bsr=False,
                             device="cpu")
    assert g.ell_cols is None and g.ell_vals is None and g.ell_valid is None
    assert ge.ind_bsr is None and ge.edge is None
    np.testing.assert_array_equal(g.mask.numpy(), np.asarray(jg.mask))
    for name in ("mask", "ell_cols", "ell_vals", "ell_valid"):
        np.testing.assert_array_equal(getattr(ge, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert (g.r is None) == weighted == (jg.r is None)
    if not weighted:
        np.testing.assert_array_equal(g.r.numpy(), np.asarray(jg.r))
    # structure stream: JAX's panel stream without its padding and
    # placeholder blocks (all-zero) holds the port's real blocks in order
    ind = g.ind_bsr
    words = np.asarray(jg.ind_bsr.blk_vals)
    real = words.reshape(words.shape[0], -1).any(axis=1)
    nz = ind.blk_vals.numpy().reshape(ind.num_blocks, -1).any(axis=1)
    np.testing.assert_array_equal(ind.blk_vals.numpy()[nz], words[real])
    np.testing.assert_array_equal(ind.blk_rows.numpy()[nz],
                                  np.asarray(jg.ind_bsr.blk_rows)[real])
    np.testing.assert_array_equal(ind.blk_cols.numpy()[nz],
                                  np.asarray(jg.ind_bsr.blk_cols)[real])
    # and the int8 stream of JAX's BsrMatrix.from_scipy, bit-packed
    s = sp.csr_matrix(adj).copy()
    s.data[:] = 1.0
    s.resize(g.n_pad, g.n_pad)
    jb = JBsr.from_scipy(s, 128, dtype=np.int8)
    np.testing.assert_array_equal(
        ind.blk_vals.numpy(),
        pack_bits_blocks(np.asarray(jb.blk_vals)[: jb.nb_real]))
    np.testing.assert_array_equal(g.ind_row_ptr.numpy()[:-1],
                                  np.asarray(jax_row_ptr(jb))[:-1])
    if weighted:
        # the SpMM's operand: Anorm's values on the structure blocks, equal
        # to `edge_values` of JAX's own f32 value blocks (the same
        # 128-wide blocks)
        assert g.edge.words is ind.blk_vals
        nb = jg.bsr.nb_real
        rebuilt = edge_values(torch.from_numpy(np.array(jg.bsr.blk_vals)[:nb]),
                              torch.from_numpy(np.array(jg.row_ptr)))
        np.testing.assert_array_equal(rebuilt.words.numpy(),
                                      ind.blk_vals.numpy())
        np.testing.assert_array_equal(rebuilt.vals.numpy(),
                                      g.edge.vals.numpy())
        np.testing.assert_array_equal(rebuilt.off.numpy(),
                                      g.edge.off.numpy())
        assert g.edge.vals.numel() == adj.nnz
    else:
        assert jg.bsr is None and g.edge is None


@pytest.mark.parametrize("seed,max_rounds", [(0, None), (1, None), (2, 2),
                                            (3, None)])
def test_lgs_routes_bit_equal_to_jax_and_host(seed, max_rounds):
    """`bsr_lgs` (the plain rank and spread passes, over bitmap and int8
    blocks) and `ell_lgs` against the JAX package. 300 links padded to 384:
    the padded tail has no neighbours, so a decided row's sentinel maximum
    must not make it win. Seed 3 also isolates every 9th link and leaves
    every 5th out of the mask (the first round then waits for a read)."""
    adj, wts, _ = T.geometric_conflict_graph(300, avg_degree=8.0,
                                             seed=10 + seed)
    if seed == 1:
        wts = np.round(wts * 4) / 4          # many ties: broken by node id
    if seed == 3:
        keep = np.arange(300) % 9 != 0
        adj = sp.csr_matrix(adj.multiply(keep[:, None]).multiply(keep))
        adj.eliminate_zeros()
    gb = T.build_large_graph(adj, block_size=128, use_bsr=True, device="cpu")
    g8 = _int8_copy(gb, adj)
    assert gb.bitmap and not g8.bitmap
    w = _wpad(wts, gb.n_pad)
    wt = torch.from_numpy(w)
    mask = gb.mask
    if seed == 3:
        mask = mask & (torch.arange(gb.n_pad) % 5 != 0)
    outs = [T.bsr_lgs(g, wt, g.mask if seed != 3 else mask, max_rounds)
            for g in (g8, gb)]
    ge = T.build_large_graph(adj, block_size=128, use_bsr=False,
                             device="cpu")
    outs.append(ell_lgs(ge.ell_cols, ge.ell_valid, wt, mask, max_rounds))
    jsel, jutil, jrounds = jax_ell_lgs(
        jnp.asarray(ge.ell_cols.numpy()), jnp.asarray(ge.ell_valid.numpy()),
        jnp.asarray(w), jnp.asarray(mask.numpy()), max_rounds)
    jg = J.build_large_graph(adj, block_size=128, use_pallas=True,
                             interpret=True)
    psel, _, prounds = jax.jit(
        lambda a, w_, m: J.bsr_lgs(jg, a, w_, m, max_rounds))(
            J.graph_arrays(jg), jnp.asarray(w), jnp.asarray(mask.numpy()))
    for sel, util, rounds in outs:
        assert sel.dtype == torch.int8
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(sel.numpy(), np.asarray(psel))
        assert int(rounds) == int(jrounds) == int(prounds)
        np.testing.assert_allclose(float(util), float(jutil), rtol=1e-6)
    assert not outs[1][0][~mask].any()
    if seed == 3:
        isolated = torch.from_numpy(np.flatnonzero(~keep))
        assert (outs[1][0][isolated] == mask[isolated].to(torch.int8)).all()
        return
    if max_rounds is None:
        ref_set, ref_util = local_greedy_search(adj, wts)
        sel = outs[1][0].numpy()
        assert set(np.flatnonzero(sel == 1).tolist()) == ref_set
        assert not (sel == -1).any() and not sel[gb.n:].any()


@pytest.mark.parametrize("num_layer,max_degree,weighted", [
    (1, 1, False), (3, 1, False), (2, 2, False), (2, 1, True)])
def test_exact_forward_matches_jax(num_layer, max_degree, weighted):
    adj, _, _ = T.geometric_conflict_graph(500, avg_degree=12.0, seed=3)
    if weighted:
        adj = adj * 2.0
    params, tree = _flax_params(num_layer, 16, max_degree)
    jg = J.build_large_graph(adj, block_size=128, use_pallas=False)
    feats = np.asarray(jg.mask, np.float32)[:, None]
    ref = np.asarray(J.large_gcn_forward(
        jg, J.params_to_list(params), jnp.asarray(feats),
        max_degree=max_degree))
    plist = T.params_to_list(tree, device="cpu")
    for use_bsr in (False, True):
        g = T.build_large_graph(adj, block_size=128, use_bsr=use_bsr,
                                device="cpu")
        got = T.large_gcn_forward(g, plist, torch.from_numpy(feats),
                                  max_degree=max_degree, fused=False)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_exact_switch_and_fused_default(monkeypatch):
    adj, _, _ = T.geometric_conflict_graph(400, avg_degree=10.0, seed=6)
    _, tree = _flax_params(2, 16)
    plist = T.params_to_list(tree, device="cpu")
    g = T.build_large_graph(adj, block_size=128, use_bsr=True, device="cpu")
    x = g.mask.to(torch.float32)[:, None]
    exact = T.large_gcn_forward(g, plist, x, fused=False)
    fused = T.large_gcn_forward(g, plist, x)
    assert not torch.equal(exact, fused)          # bf16 activations
    monkeypatch.setenv("DISTGCN_LARGE_EXACT", "1")
    torch.testing.assert_close(T.large_gcn_forward(g, plist, x), exact,
                               rtol=0, atol=0)
    # the fused kernel has only leaky_relu hidden layers: another hidden
    # activation takes the exact route
    monkeypatch.delenv("DISTGCN_LARGE_EXACT")
    torch.testing.assert_close(
        T.large_gcn_forward(g, plist, x, hidden_act=identity),
        T.large_gcn_forward(g, plist, x, hidden_act=identity, fused=False),
        rtol=0, atol=0)


@pytest.mark.parametrize("route", ["ell", "bsr"])
@pytest.mark.parametrize("predict", ["mwis", "dqn"])
def test_make_large_solve_matches_jax(route, predict):
    adj, wts, _ = T.geometric_conflict_graph(256, avg_degree=8.0, seed=11)
    params, tree = _flax_params(2, 8, seed=2)
    if route == "ell":
        jg = J.build_large_graph(adj, block_size=128, use_pallas=False)
    else:
        jg = J.build_large_graph(adj, block_size=128, use_pallas=True,
                                 interpret=True)
    w = _wpad(wts, jg.n_pad)
    jsel, jutil, jgutil = J.make_large_solve(
        jg, predict=predict, with_baseline=True)(J.params_to_list(params),
                                                 jnp.asarray(w))
    g = T.build_large_graph(adj, block_size=128, use_bsr=route == "bsr",
                            device="cpu")
    sel, util, gutil = T.make_large_solve(g, predict=predict,
                                          with_baseline=True)(
        T.params_to_list(tree, device="cpu"), torch.from_numpy(w))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(float(util), float(jutil), rtol=1e-5)
    np.testing.assert_allclose(float(gutil), float(jgutil), rtol=1e-5)


@pytest.mark.parametrize("route", ["ell", "bsr"])
def test_large_closed_loop_runs_and_drains(route):
    adj, _, _ = T.geometric_conflict_graph(300, avg_degree=6.0, seed=31)
    g = T.build_large_graph(adj, block_size=128, use_bsr=route == "bsr",
                            device="cpu")
    _, tree = _flax_params(2, 8, seed=5)
    run = T.make_large_closed_loop(g, timeslots=40, load=0.5)
    qT, metrics = run(T.params_to_list(tree, device="cpu"),
                      torch.zeros(g.n_pad),
                      torch.Generator().manual_seed(0))
    assert float(metrics["avg_utility"]) > 0
    assert 0 < float(metrics["sched_rate"]) < 1
    assert not qT[g.n:].any()                     # padding never queues
    assert bool((qT >= 0).all()) and bool(torch.isfinite(qT).all())
    assert float(metrics["avg_queue_len"]) < 40 * 25.0


def test_dqn_closed_loop_runs_gcn_every_slot():
    adj, _, _ = T.geometric_conflict_graph(200, avg_degree=6.0, seed=3)
    g = T.build_large_graph(adj, block_size=128, use_bsr=True, device="cpu")
    _, tree = _flax_params(2, 8, seed=5)
    run = T.make_large_closed_loop(g, timeslots=5, predict="dqn",
                                   feature_mode="dqn")
    qT, metrics = run(T.params_to_list(tree, device="cpu"),
                      torch.zeros(g.n_pad), torch.Generator().manual_seed(1))
    assert float(metrics["avg_utility"]) > 0 and not qT[g.n:].any()


def test_bsr_lgs_rejects_ranks_beyond_f32():
    adj, wts, _ = T.geometric_conflict_graph(200, avg_degree=6.0, seed=3)
    g = T.build_large_graph(adj, block_size=128, use_bsr=True, device="cpu")
    g.ind_bsr.n_rows = 1 << 24
    with pytest.raises(ValueError, match="2\\^24"):
        T.bsr_lgs(g, torch.from_numpy(_wpad(wts, g.n_pad)), g.mask)


def test_params_to_list_carries_checkpoint_and_flax_trees():
    tree = load_params(CKPT)
    plist = T.params_to_list(tree, device="cpu")
    jlist = J.params_to_list(tree)
    assert len(plist) == len(jlist) == 20
    for p, q in zip(plist, jlist):
        assert set(p) == set(q)
        for k in p:
            assert p[k].dtype == torch.float32
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(q[k]))
    params, _ = _flax_params(3, 8)               # JAX arrays as leaves
    plist = T.params_to_list(params, device="cpu")
    np.testing.assert_array_equal(plist[2]["w_1"].numpy(),
                                  np.asarray(params["gc3"]["w_1"]))


def test_params_to_list_pads_for_the_fused_kernel_once():
    adj, _, _ = T.geometric_conflict_graph(300, avg_degree=8.0, seed=9)
    g = T.build_large_graph(adj, block_size=128, use_bsr=True, device="cpu")
    _, tree = _flax_params(2, 16)
    plist = T.params_to_list(tree, device="cpu")
    x = g.mask.to(torch.float32)[:, None]
    out = T.large_gcn_forward(g, plist, x)
    first = plist.fused()
    assert plist.fused() is first                 # made once
    for got, want in zip(first, pad_params(list(plist))):
        for k in want:
            assert torch.equal(got[k], want[k])
    # a plain list pads on every forward, to the same result
    assert torch.equal(T.large_gcn_forward(g, list(plist), x), out)
    plist[1]["w_1"].mul_(2.0)                     # changed in place
    again = plist.fused()
    assert again is not first
    assert torch.equal(again[1]["w1"][:16, :1], plist[1]["w_1"])
    assert not torch.equal(T.large_gcn_forward(g, plist, x), out)
