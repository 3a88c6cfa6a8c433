"""Port parity: LGS ranks and solves against JAX XLA, JAX Pallas
(interpret mode) and the host `local_greedy_search`.

Selections and round counts are integers and must be bit-equal; the
utility is a float sum taken in another order (rtol 1e-6; one unit in the
last place in 16-bit types). The CUDA kernel itself runs only on the card
(`-m cuda`), where it ranks the weights itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_graph
from distgcn_tpu.core.graph import GraphBatch as JGraphBatch
from distgcn_tpu.ops.lgs import batched_lgs as jax_lgs
from distgcn_tpu.ops.lgs import lgs_ranks as jax_ranks
from distgcn_tpu.ops.lgs_pallas import batched_lgs_pallas
from distgcn_tpu.solvers.greedy import local_greedy_search
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.ops import lgs
from distgcn_tpu_torch.ops.lgs_cuda import (MAX_N, SMEM_BYTES,
                                            batched_lgs_kernel, rows_in_smem,
                                            smem_bytes)
from distgcn_tpu_torch.models.gcn import make_model_from_config
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.utils.config import Config


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _weights(rng, n, case):
    if case == "ties":
        return np.ones(n)                 # tie-break by smaller node id
    if case == "negative":
        return rng.random(n) - 0.6
    if case == "coarse":
        return np.round(rng.random(n) * 4) / 4   # many partial ties
    if case == "nan":                     # NaN ranks below every number
        w = rng.random(n)
        w[rng.random(n) < 0.25] = np.nan
        w[rng.random(n) < 0.2] = 0.0
        w[rng.random(n) < 0.2] = -0.0
        return w
    return rng.random(n)


def _case(rng, case, b=4, pad=128):
    adjs = [random_graph(rng, n=int(rng.integers(20, 60)), p=0.12)
            for _ in range(b)]
    wtss = [_weights(rng, a.shape[0], case) for a in adjs]
    jb = JGraphBatch.from_scipy(adjs, wtss, pad_to=pad)
    tb = GraphBatch.from_scipy(adjs, wtss, pad_to=pad, device="cpu")
    return jb, tb, adjs, wtss


@pytest.mark.parametrize("case", ["random", "ties", "negative", "coarse",
                                  "nan"])
def test_lgs_ranks_match_jax(rng, case):
    w = np.stack([_weights(rng, 37, case) for _ in range(3)]).astype(
        np.float32)
    w[0, :5] = 0.0
    w[0, 5:8] = -0.0                      # JAX sorts -0.0 == 0.0
    got = lgs.lgs_ranks(torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_ranks(jnp.asarray(w))))
    assert sorted(got[1].tolist()) == list(range(1, 38))


def test_lgs_ranks_signed_zero_and_nan_order():
    """The order the kernel's in-kernel ranking counts: descending weight,
    ties to the smaller id, -0.0 equal to +0.0, NaN after every number."""
    w = np.array([[1.0, np.nan, 0.0, -0.0, 2.0, np.nan, 0.0]], np.float32)
    want = [[6, 2, 5, 4, 7, 1, 3]]
    assert lgs.lgs_ranks(torch.from_numpy(w)).tolist() == want
    assert np.asarray(jax_ranks(jnp.asarray(w))).tolist() == want


@pytest.mark.parametrize("case,max_rounds", [
    ("random", None), ("ties", None), ("negative", None), ("coarse", None),
    ("random", 1), ("ties", 2)])
def test_batched_lgs_matches_jax_pallas_and_host(rng, case, max_rounds):
    jb, tb, adjs, wtss = _case(rng, case)
    sel, util, rounds = lgs.batched_lgs(tb.adj, tb.wts, tb.mask, max_rounds)
    assert sel.dtype == torch.int8 and rounds.dtype == torch.int32
    assert rounds.dim() == 0
    jsel, jutil, jrounds = jax_lgs(jb.adj, jb.wts, jb.mask, max_rounds)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert int(rounds) == int(jrounds)
    np.testing.assert_allclose(util.numpy(), np.asarray(jutil), rtol=1e-6)
    psel, putil, prounds = batched_lgs_pallas(
        (jb.adj > 0).astype(jnp.int8), jb.wts, jb.mask, max_rounds,
        interpret=True)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(psel))
    assert int(rounds) == int(jnp.max(prounds))
    if max_rounds is None:
        sel = sel.numpy()
        assert not np.any(sel == -1)
        assert not np.any(sel[~tb.mask.numpy()] != 0)   # padding -> 0
        for i, (a, w) in enumerate(zip(adjs, wtss)):
            mwis, total = local_greedy_search(a, w)
            assert set(np.flatnonzero(sel[i, :a.shape[0]] == 1)) == mwis
            assert float(util[i]) == pytest.approx(total, rel=1e-6)


def test_batched_lgs_past_1024_nodes_matches_jax_and_host(rng):
    """N past the kernel's old 1024-node limit: the port's `batched_lgs`
    bit-equal to JAX's XLA `batched_lgs` and to the host
    `local_greedy_search` (JAX's Pallas interpret run is left out at this
    size)."""
    n = 1100
    adjs = [random_graph(rng, n=int(k), p=20.0 / n) for k in (n, 1037)]
    wtss = [_weights(rng, a.shape[0], "coarse") for a in adjs]
    jb = JGraphBatch.from_scipy(adjs, wtss, pad_to=n)
    tb = GraphBatch.from_scipy(adjs, wtss, pad_to=n, device="cpu")
    sel, util, rounds = lgs.batched_lgs(tb.adj, tb.wts, tb.mask)
    jsel, jutil, jrounds = jax_lgs(jb.adj, jb.wts, jb.mask)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert int(rounds) == int(jrounds)
    np.testing.assert_allclose(util.numpy(), np.asarray(jutil), rtol=1e-6)
    for i, (a, w) in enumerate(zip(adjs, wtss)):
        mwis, total = local_greedy_search(a, w)
        assert set(np.flatnonzero(sel[i, :a.shape[0]].numpy() == 1)) == mwis
        assert float(util[i]) == pytest.approx(total, rel=1e-6)


def test_kernel_shared_memory_layout():
    """MAX_N is the largest N whose keys and state words fit a CTA's
    shared memory, at least the 44,275 of the kernel with ranks outside;
    the order map and the row bitmask stay there up to N=1312 and move to
    the device scratch past it."""
    assert smem_bytes(MAX_N, False) <= SMEM_BYTES
    assert smem_bytes(MAX_N + 1, False) > SMEM_BYTES
    assert MAX_N >= 44275
    assert rows_in_smem(1) and rows_in_smem(1024) and rows_in_smem(1100)
    assert rows_in_smem(1312) and not rows_in_smem(1313)
    assert not rows_in_smem(1536) and not rows_in_smem(MAX_N)
    # keys [256] | order [256] | remain x2, win, chosen [8] | rows [256][9]
    assert smem_bytes(256, True) == 4 * (256 + 256 + 4 * 8 + 256 * 9)
    assert smem_bytes(100, False) == 4 * (128 + 4 * 4)


def test_batched_greedy_is_lgs():
    assert lgs.batched_greedy is lgs.batched_lgs


def test_plain_lgs_accepts_float_adjacency(rng):
    _, tb, _, _ = _case(rng, "random", b=2, pad=64)
    a = lgs.batched_lgs(tb.adj, tb.wts, tb.mask)
    b = lgs.batched_lgs(tb.adj.float(), tb.wts, tb.mask)
    assert torch.equal(a[0], b[0]) and int(a[2]) == int(b[2])


def test_kernel_wrapper_rejects_bad_inputs(rng):
    _, tb, _, _ = _case(rng, "random", b=2, pad=64)
    # CPU tensors: the wrapper never falls back to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        batched_lgs_kernel(tb.adj, tb.wts, tb.mask)
    with pytest.raises(ValueError, match="shape"):
        batched_lgs_kernel(tb.adj[:, :32], tb.wts, tb.mask)
    with pytest.raises(ValueError, match="int8 or bool"):
        batched_lgs_kernel(tb.adj.float(), tb.wts, tb.mask)
    with pytest.raises(ValueError, match="contiguous"):
        batched_lgs_kernel(tb.adj.transpose(1, 2), tb.wts, tb.mask)
    # the kernel reads float32, bfloat16 and float16 weights; float64 goes
    # in as ranked keys; nothing else
    for dtype in (torch.int32, torch.float8_e4m3fn, torch.complex64):
        with pytest.raises(ValueError, match="float32, bfloat16, float16 "
                           "or float64"):
            batched_lgs_kernel(tb.adj, tb.wts.to(dtype), tb.mask)
    for dtype in (torch.float32, torch.bfloat16, torch.float16,
                  torch.float64):
        with pytest.raises(ValueError, match="CUDA"):
            batched_lgs_kernel(tb.adj, tb.wts.to(dtype), tb.mask)
    n = MAX_N + 1        # a broadcast view: the range check comes first
    with pytest.raises(ValueError, match=f"range 1..{MAX_N}"):
        batched_lgs_kernel(torch.zeros((1, 1, 1), dtype=torch.int8)
                           .expand(1, n, n), torch.ones((1, n)),
                           torch.ones((1, n), dtype=bool))


def _card_inputs(seed, n, case):
    """A batch of seeded random graphs at density ~20/n with ragged masks:
    int8 adj [b, n, n], float64 weights [b, n] (times the mask) and bool
    mask, as numpy arrays."""
    rng = np.random.default_rng(seed)
    b = 32 if n <= 1024 else 4
    a = rng.random((b, n, n)) < min(1.0, 20.0 / n)
    a = np.triu(a, 1)
    a = a | a.transpose(0, 2, 1)
    m = np.arange(n)[None, :] < rng.integers(max(1, n // 2), n + 1, b)[:, None]
    a = a & m[:, :, None] & m[:, None, :]
    w = np.stack([_weights(rng, n, case) for _ in range(b)]) * m
    return a.astype(np.int8), w, m


@pytest.mark.cuda
@pytest.mark.parametrize("n,case,max_rounds", [
    (256, "random", None), (256, "ties", None), (256, "negative", None),
    (256, "random", 1), (100, "random", None), (24, "ties", None),
    (1, "random", None), (1024, "coarse", None),
    # past 1024 nodes: several nodes per thread; ragged N; from 1536 on the
    # row bitmask lives in the device-memory scratch
    (1025, "random", None), (1100, "ties", None), (1536, "negative", None),
    (2048, "random", 1), (4096, "coarse", None)])
def test_kernel_matches_plain_on_card(cuda, n, case, max_rounds):
    a, w, m = _card_inputs(n, n, case)
    adj = torch.from_numpy(a).to(cuda)
    wts = torch.from_numpy(w.astype(np.float32)).to(cuda)
    mask = torch.from_numpy(m).to(cuda)
    sel, util, rounds = batched_lgs_kernel(adj, wts, mask, max_rounds)
    torch.cuda.synchronize()
    psel, putil, prounds = lgs.batched_lgs_plain(adj, wts, mask, max_rounds)
    assert torch.equal(sel, psel)
    assert int(rounds.max()) == int(prounds)
    torch.testing.assert_close(util, putil, rtol=1e-6, atol=1e-6)
    # batched_lgs on CUDA tensors goes through the kernel
    before = batched_lgs_kernel.launches
    dsel, _, drounds = lgs.batched_lgs(adj.bool(), wts, mask, max_rounds)
    assert batched_lgs_kernel.launches == before + 1
    assert torch.equal(dsel, psel) and int(drounds) == int(prounds)


CARD_NS = [1, 24, 100, 256, 1024, 1025, 1100, 1536, 2048, 4096]


def _ulps_apart(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in units of the last place between two 16-bit
    float tensors whose values share a sign."""
    return int((got.view(torch.int16).int()
                - want.view(torch.int16).int()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nan", "equal", "bfloat16", "float16",
                                  "float64", "max_rounds_0"])
@pytest.mark.parametrize("n", CARD_NS)
def test_kernel_weight_cases_match_plain_on_card(cuda, n, case):
    """The kernel ranks the weights itself: signed zeros and NaN, all-equal
    weights (ids decide every tie, padding included), weights in bfloat16
    and float16 (widened in the kernel) and float64 (ranked keys), and no
    round at all. sel and rounds bit-equal to `batched_lgs_plain` on CPU
    copies (the version held to JAX); the utility within rtol 1e-6 in
    float32 and float64 (another summation order) and within one unit in
    the last place in 16-bit types (the kernel rounds its sum once)."""
    a, w, m = _card_inputs(n + 7, n, "nan" if case == "nan" else "random")
    if case == "equal":
        w = np.full_like(w, 0.5)
    dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16,
             "float64": torch.float64}.get(case, torch.float32)
    max_rounds = 0 if case == "max_rounds_0" else None
    wts = torch.from_numpy(w).to(dtype)
    adj, mask = torch.from_numpy(a), torch.from_numpy(m)
    psel, putil, prounds = lgs.batched_lgs_plain(adj, wts, mask, max_rounds)
    before = batched_lgs_kernel.launches
    sel, util, rounds = batched_lgs_kernel(adj.to(cuda), wts.to(cuda),
                                           mask.to(cuda), max_rounds)
    torch.cuda.synchronize()
    assert batched_lgs_kernel.launches == before + 1
    assert util.dtype == dtype and rounds.dtype == torch.int32
    assert torch.equal(sel.cpu(), psel)
    assert int(rounds.max()) == int(prounds)
    util = util.cpu()
    if dtype in (torch.bfloat16, torch.float16):
        assert _ulps_apart(util, putil) <= 1
    else:
        torch.testing.assert_close(util, putil, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)
    if case == "max_rounds_0":
        assert int(rounds.max()) == 0 and not bool(util.any())
        assert torch.equal(sel.cpu(), torch.where(mask, -1, 0).to(torch.int8))
    if case == "nan":
        assert bool(wts.isnan().any()) and bool((wts == 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_NS)
def test_kernel_two_launches_bit_equal_on_card(cuda, n):
    """The utility is summed in one fixed order: two launches on one input
    agree bit for bit in sel, rounds and util."""
    a, w, m = _card_inputs(n + 11, n, "coarse")
    args = (torch.from_numpy(a).to(cuda),
            torch.from_numpy(w.astype(np.float32)).to(cuda),
            torch.from_numpy(m).to(cuda))
    sel, util, rounds = batched_lgs_kernel(*args)
    sel2, util2, rounds2 = batched_lgs_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(sel, sel2) and torch.equal(rounds, rounds2)
    assert torch.equal(util.view(torch.int32), util2.view(torch.int32))


@pytest.mark.cuda
def test_closed_loop_on_card_launches_lgs_kernel(cuda):
    """The closed loop goes through the kernel: one launch per slot plus
    one for the baseline."""
    rng = np.random.default_rng(0)
    adjs = [random_graph(rng, n=100, p=0.2) for _ in range(8)]
    tb = GraphBatch.from_scipy(adjs, [np.ones(100)] * 8, pad_to=128,
                               device=cuda)
    cfg = Config(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
                 max_degree=1, pad_to=128)
    tmodel = make_model_from_config(cfg, "gcn_dqn", device=cuda)
    run = device_sim.make_closed_loop(tmodel, cfg, timeslots=20,
                                      with_baseline=True)
    before = batched_lgs_kernel.launches
    qT, metrics = run(tb.adj, tb.mask, torch.zeros((8, 128), device=cuda),
                      torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert batched_lgs_kernel.launches - before == 40
    assert bool((qT >= 0).all()) and bool(torch.isfinite(qT).all())
    assert bool((qT[~tb.mask] == 0).all())
    assert bool((metrics["avg_utility_ratio"] > 0.8).all())
