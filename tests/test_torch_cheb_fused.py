"""Port parity: the fused ChebGCN layer (`ops/cheb_fused.py`) against the
JAX package's fused kernels in interpret mode and the dense f64 oracle.

The fused layer streams bf16 activations, so it is held to the JAX test's
own oracle criterion (mean relative error < 0.02, `tests/test_cheb_fused.py`
:88). Against JAX's interpret-mode forward on the row-grid and the
gather-window routes the mean relative error (measured as there) is
< 1e-3: the two differ only in the order of f32 sums and in rare one-ulp
bf16 flips. The CUDA kernel runs only on the card
(`tests/test_torch_large_kernels.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distgcn_tpu.large import build_large_graph as jax_build
from distgcn_tpu.large import geometric_conflict_graph, large_gcn_forward
from distgcn_tpu.ops import cheb_fused as J
from distgcn_tpu.ops.spmm import BsrMatrix as JBsr
from distgcn_tpu.ops.spmm import bsr_row_ptr as jax_row_ptr
from distgcn_tpu_torch.ops import cheb_fused as T
from distgcn_tpu_torch.ops.cheb_fused_cuda import fused_cheb_layer_kernel
from distgcn_tpu_torch.ops.spmm import BsrMatrix, bsr_row_ptr
from test_cheb_fused import _banded_graph, _dense_oracle, _params


def _rel_err(got, ref):
    return (np.abs(got - ref) / (np.abs(ref) + 1e-2)).mean()


def _port_structure(adj, bs, bitmap):
    ind = adj.copy()
    ind.data[:] = 1.0
    b = BsrMatrix.from_scipy(ind, bs, dtype="bits" if bitmap else np.int8,
                             device="cpu")
    deg = np.asarray(adj.sum(1)).ravel()
    r = np.zeros(b.n_rows, np.float32)
    r[: adj.shape[0]] = np.where(deg > 0, deg ** -0.5, 0.0)
    return b, torch.from_numpy(r)


def _tparams(params):
    return [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
            for p in params]


def _port_forward(adj, params, feats, bs=128, bitmap=True, final_leaky=False):
    b, r = _port_structure(adj, bs, bitmap)
    x = np.zeros((b.n_rows, feats.shape[1]), np.float32)
    x[: feats.shape[0]] = feats
    out = T.fused_forward(b.blk_vals, bsr_row_ptr(b), b.blk_cols, r,
                          T.pad_params(_tparams(params)), torch.from_numpy(x),
                          b.n_rows, bs, final_act_mode=int(final_leaky),
                          bitmap=bitmap)
    assert out.dtype == torch.float32 and out.shape == (b.n_rows, 32)
    assert not out[:, 1:].any()               # padded lanes of the head
    return out.numpy()[: adj.shape[0], :1]


@pytest.mark.parametrize("final_leaky", [False, True])
@pytest.mark.parametrize("bitmap", [False, True])
def test_fused_forward_meets_dense_oracle(final_leaky, bitmap):
    adj = _banded_graph()
    feats = np.random.default_rng(2).random((adj.shape[0], 1)).astype(
        np.float32)
    params = _params([1, 32, 32, 1])
    got = _port_forward(adj, params, feats, bitmap=bitmap,
                        final_leaky=final_leaky)
    assert got.shape == (adj.shape[0], 1)
    oracle = _dense_oracle(adj, params, feats, final_leaky)
    assert _rel_err(got, oracle) < 0.02


@pytest.mark.parametrize("final_leaky", [False, True])
def test_fused_forward_matches_jax_row_grid(final_leaky):
    adj = _banded_graph()
    n = adj.shape[0]
    feats = np.random.default_rng(2).random((n, 1)).astype(np.float32)
    params = _params([1, 32, 32, 1])
    ind = adj.copy()
    ind.data[:] = 1.0
    jb = JBsr.from_scipy(ind, 128, dtype=np.int8)
    deg = np.asarray(adj.sum(1)).ravel()
    r = np.where(deg > 0, deg ** -0.5, 0.0).astype(np.float32)
    ref = np.asarray(J.fused_forward(
        jnp.asarray(jb.blk_vals), jax_row_ptr(jb), jnp.asarray(jb.blk_cols),
        jnp.asarray(r.reshape(-1, 1)), params, jnp.asarray(feats),
        jb.n_rows, 128, final_act_mode=int(final_leaky), interpret=True))[:n]
    for bitmap in (False, True):
        got = _port_forward(adj, params, feats, bitmap=bitmap,
                            final_leaky=final_leaky)
        assert _rel_err(got, ref) < 1e-3


def test_fused_forward_matches_jax_gather_window_route():
    adj, _, _ = geometric_conflict_graph(1500, avg_degree=10.0, seed=5)
    jg = jax_build(adj, block_size=128, use_pallas=True, interpret=True,
                   ind_block_size=128)
    assert jg.bitmap and jg.gather is not None      # the gwin kernel runs
    params = _params([1, 16, 16, 1], seed=7)
    feats = np.random.default_rng(8).random((adj.shape[0], 1)).astype(
        np.float32)
    x = np.zeros((jg.n_pad, 1), np.float32)
    x[: adj.shape[0]] = feats
    ref = np.asarray(large_gcn_forward(jg, params, jnp.asarray(x)))
    got = _port_forward(adj, params, feats)
    assert _rel_err(got, ref[: adj.shape[0]]) < 1e-3


def test_one_layer_matches_jax_kernel_outputs():
    """A hidden layer (bf16 out) and the head (f32 out) of the JAX row-grid
    kernel, on the same bf16 input."""
    adj = _banded_graph(n=256)
    rng = np.random.default_rng(4)
    params = _params([32, 32], seed=3)[0]
    b, r = _port_structure(adj, 128, True)
    h = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32)
                         ).to(torch.bfloat16)
    jp = J.pad_layer_params(params, 128)
    tp = T.pad_layer_params(_tparams([params])[0], 32)
    np.testing.assert_array_equal(tp["w01"].numpy(),
                                  np.asarray(jp["w01"])[:32, :32])
    np.testing.assert_array_equal(tp["bias"].numpy(),
                                  np.asarray(jp["bias"])[:, :32])
    ind = adj.copy()
    ind.data[:] = 1.0
    jb = JBsr.from_scipy(ind, 128, dtype=np.int8)
    hj = jnp.pad(jnp.asarray(h.float().numpy()), ((0, 0), (0, 96))).astype(
        jnp.bfloat16)
    for act, dt, jdt in ((1, torch.bfloat16, jnp.bfloat16),
                         (0, torch.float32, jnp.float32)):
        got = T.fused_cheb_layer(b.blk_vals, bsr_row_ptr(b), b.blk_cols, h,
                                 r, tp["w1"], tp["w01"], tp["bias"], 256,
                                 128, act, dt, bitmap=True)
        assert got.dtype == dt
        ref = np.asarray(J._fused_cheb_layer(
            jnp.asarray(jb.blk_vals), jax_row_ptr(jb),
            jnp.asarray(jb.blk_cols), hj, jnp.asarray(r.numpy()[None]),
            jp["w1"], jp["w01"], jp["bias"], 256, 128, act_mode=act,
            out_dtype=jdt, interpret=True)).astype(np.float32)[:, :32]
        got = got.float().numpy()
        # two bf16 ulps at the layer's scale (a one-ulp flip of bf16(lag)
        # can cancel against y)
        assert np.abs(got - ref).max() <= 2.0 ** -6 * np.abs(ref).max()
        assert _rel_err(got, ref) < 1e-3


def test_fused_kernel_wrapper_rejects_bad_inputs():
    adj = _banded_graph(n=256)
    b, r = _port_structure(adj, 128, True)
    rp = bsr_row_ptr(b)
    h = torch.zeros((256, 32), dtype=torch.bfloat16)
    w = torch.zeros((32, 32))
    bias = torch.zeros(32)
    with pytest.raises(ValueError, match="CUDA"):
        fused_cheb_layer_kernel(b.blk_vals, rp, b.blk_cols, h, r, w, w,
                                bias, 256, 128, 1, bitmap=True)
    with pytest.raises(ValueError, match="F in"):
        fused_cheb_layer_kernel(b.blk_vals, rp, b.blk_cols,
                                torch.zeros((256, 40), dtype=torch.bfloat16),
                                r, w, w, bias, 256, 128, 1, bitmap=True)
