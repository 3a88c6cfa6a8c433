"""Port parity: LGS on D weight variants of a shared adjacency
(`batched_lgs_multi`) and LGS with the reference's communication counters
(`lgs_round_counts`), against the JAX package's `ops/lgs.py`.

Selections, round counts and counters are integers and must be bit-equal;
the utility is a float sum taken in another order (rtol 1e-6). On the card
(`-m cuda`) `batched_lgs_multi` is one launch of the LGS kernel in its
shared-adjacency mode (``share = D``), held bit-equal to the plain version,
and ``share = 1`` is the kernel's ordinary launch. This file imports no
flax-backed JAX module, so its card tests collect where the card is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_graph
from distgcn_tpu.ops import lgs as jlgs
from distgcn_tpu_torch.ops import lgs
from distgcn_tpu_torch.ops.lgs_cuda import batched_lgs_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _weights(rng, shape, case):
    if case == "ties":
        return np.round(rng.random(shape) * 3) / 3     # many ties
    if case == "negative":
        return rng.random(shape) - 0.6
    return rng.random(shape)


def _batch(rng, q=3, pad=64, lo=20, hi=60, p=0.12):
    """q padded graphs with ragged masks: adj [Q, pad, pad] int8, mask
    [Q, pad] bool."""
    adj = np.zeros((q, pad, pad), np.int8)
    mask = np.zeros((q, pad), bool)
    for i in range(q):
        n = int(rng.integers(lo, hi + 1))
        adj[i, :n, :n] = random_graph(rng, n, p).toarray() > 0
        mask[i, :n] = True
    return adj, mask


def _as_jax(*arrays):
    return [jnp.asarray(x) for x in arrays]


def _as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


@pytest.mark.parametrize("case", ["random", "ties", "negative"])
@pytest.mark.parametrize("max_rounds", [None, 1, 3])
def test_multi_matches_jax(rng, case, max_rounds):
    adj, mask = _batch(rng)
    w = _weights(rng, (3, 5, 64), case).astype(np.float32) * mask[:, None]
    js, ju, jr = jlgs.batched_lgs_multi(*_as_jax(adj, w, mask),
                                        max_rounds=max_rounds)
    ts, tu, tr = lgs.batched_lgs_multi(*_as_torch(adj, w, mask),
                                       max_rounds=max_rounds)
    assert ts.dtype == torch.int8 and tr.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tr) == int(jr)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_per_variant_mask_matches_separate_jax_lgs(rng, case):
    """A mask per variant (the rollout's branches): each variant equals
    its own JAX `batched_lgs` run on the broadcast adjacency."""
    adj, mask = _batch(rng, q=2)
    d = 4
    vmask = mask[:, None, :] & (rng.random((2, d, 64)) < 0.7)
    w = _weights(rng, (2, d, 64), case).astype(np.float32)
    ts, tu, tr = lgs.batched_lgs_multi(*_as_torch(adj, w, vmask))
    rounds = 0
    for k in range(d):
        js, ju, jr = jlgs.batched_lgs(*_as_jax(adj, w[:, k], vmask[:, k]))
        np.testing.assert_array_equal(ts[:, k].numpy(), np.asarray(js))
        np.testing.assert_allclose(tu[:, k].numpy(), np.asarray(ju),
                                   rtol=1e-6, atol=1e-6)
        rounds = max(rounds, int(jr))
    assert int(tr) == rounds


def test_multi_rejects_bad_mask(rng):
    adj, mask = _batch(rng, q=2)
    w = torch.rand((2, 3, 64))
    with pytest.raises(ValueError, match="mask"):
        lgs.batched_lgs_multi(torch.from_numpy(adj), w,
                              torch.ones((2, 2, 64), dtype=torch.bool))


def test_multi_kernel_route_needs_a_card(rng):
    """On CPU tensors the dispatcher runs the plain version; the kernel
    wrapper itself never falls back and checks the share."""
    adj, mask = _batch(rng, q=2)
    a, m = _as_torch(adj, mask)
    w = torch.rand((2 * 3, 64))
    rows = m.repeat_interleave(3, dim=0)
    with pytest.raises(ValueError, match="CUDA"):
        batched_lgs_kernel(a, w, rows, share=3)
    with pytest.raises(ValueError, match="share=2"):
        batched_lgs_kernel(a, w, rows, share=2)


@pytest.mark.parametrize("case", ["random", "ties", "negative"])
def test_round_counts_match_jax(rng, case):
    adj, mask = _batch(rng, q=4)
    w = _weights(rng, (4, 64), case).astype(np.float32) * mask
    want = jlgs.lgs_round_counts(*_as_jax(adj, w, mask))
    got = lgs.lgs_round_counts(*_as_torch(adj, w, mask))
    for name, g, j in zip(("sel", "rounds", "p2p", "bst"),
                          (got[0], got[2], got[3], got[4]),
                          (want[0], want[2], want[3], want[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j),
                                      err_msg=name)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    assert got[3].dtype == got[4].dtype == torch.int32


# ---------------------------------------------------------------------------
# the kernel's shared-adjacency mode, on the card
# ---------------------------------------------------------------------------

def _card_case(seed, q, d, n, per_variant):
    rng = np.random.default_rng(seed)
    a = rng.random((q, n, n)) < min(1.0, 20.0 / n)
    a = np.triu(a, 1)
    a = a | a.transpose(0, 2, 1)
    m = np.arange(n)[None, :] < rng.integers(max(1, n // 2), n + 1, q)[:, None]
    a = a & m[:, :, None] & m[:, None, :]
    w = rng.random((q, d, n)).astype(np.float32)
    w[:, :, : n // 8] = 0.5                       # ties across variants
    mask = (m[:, None, :] & (rng.random((q, d, n)) < 0.8) if per_variant
            else m)
    return a.astype(np.int8), w, mask


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 100, 128, 256, 700, 1500])
@pytest.mark.parametrize("per_variant", [False, True])
def test_shared_mode_matches_plain_on_card(cuda, n, per_variant):
    q, d = (4, 8) if n <= 256 else (2, 3)
    a, w, mask = _card_case(n, q, d, n, per_variant)
    args = [t.to(cuda) for t in _as_torch(a, w, mask)]
    before = batched_lgs_kernel.launches
    sel, util, rounds = lgs.batched_lgs_multi(*args)
    assert batched_lgs_kernel.launches == before + 1
    psel, putil, prounds = lgs.batched_lgs_multi_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(sel, psel)
    assert int(rounds) == int(prounds)
    torch.testing.assert_close(util, putil, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 100, 256])
def test_share_one_is_the_ordinary_launch_on_card(cuda, n):
    """share=1 is today's kernel: bit-equal to a launch without the
    argument; and share=D equals D ordinary launches on a
    repeat_interleave'd adjacency."""
    a, w, mask = _card_case(n + 1, 4, 6, n, True)
    adj, wt, mk = [t.to(cuda) for t in _as_torch(a, w, mask)]
    rows, rmask = wt.reshape(24, n), mk.reshape(24, n).contiguous()
    rep = adj.repeat_interleave(6, dim=0)
    one = batched_lgs_kernel(rep, rows, rmask, share=1)
    plain = batched_lgs_kernel(rep, rows, rmask)
    shared = batched_lgs_kernel(adj, rows, rmask, share=6)
    torch.cuda.synchronize()
    for x, y, z in zip(one, plain, shared):
        assert torch.equal(x, y) and torch.equal(x, z)
