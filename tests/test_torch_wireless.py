"""Port parity: the wireless path — `data/wireless`, the host simulator
`sim/wireless` and the multi-channel device loops of `sim/device_sim` —
against the JAX package on the same inputs.

Tolerances: host code (graphs, traffic, Greedy, Greedy-Th, LGS-Seq and
Benchmark metrics) is identical; the agent's DGCN-LGS metrics are within
rtol 1e-5 (the f32 GCN scores agree to ~1e-6, the schedules are equal).
The device loops draw from a `torch.Generator`, which cannot match
`jax.random`, so their parity runs pin the draws in both packages: the
rates are constant (``rate_lo == rate_hi``) and `make_poisson_arrivals` is
replaced in each package's `device_sim` by a fixed seeded per-link arrival
array; whole episodes then agree within rtol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

from conftest import random_graph
from distgcn_tpu.agents import DQNAgent as JDQNAgent
from distgcn_tpu.data import wireless as jwireless
from distgcn_tpu.sim import device_sim as jdevice_sim
from distgcn_tpu.sim import wireless as jsim
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.data import wireless
from distgcn_tpu_torch.models.gcn import params_from_jax
from distgcn_tpu_torch.ops.lgs import batched_lgs
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.sim import wireless as sim
from distgcn_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "data", "wireless_test")
RTOL = 1e-5                # GCN-driven metrics (f32 scores)
BASE = dict(feature_size=1, hidden1=8, num_layer=2, diver_num=1,
            max_degree=1, predict="mwis", epsilon=0.0, pad_to=64)
METRICS = ("avg_queue_len", "med_queue_len", "95p_queue_len",
           "5p_queue_len", "avg_utility")


def _gdict(name):
    m = sio.loadmat(os.path.join(NETS, f"poisson_net_{name}.mat"))
    return m["gdict"][0, 0], int(np.asarray(m["random_seed"]).flatten()[0])


def _agents(**kw):
    cfg = dict(BASE, **kw)
    jag = JDQNAgent(JConfig(**cfg), model_family="gcn_dqn")
    tag = DQNAgent(Config(**cfg), model_family="gcn_dqn", device="cpu")
    tag.model.load_state_dict(params_from_jax(jag.params))
    return jag, tag


def _same_sparse(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("name", ["0000", "0015"])
def test_wireless_graphs_match_jax(name):
    gdict, seed = _gdict(name)
    for got, want in zip(wireless._unpack_gdict(gdict),
                         jwireless._unpack_gdict(gdict)):
        np.testing.assert_array_equal(got, want)
    adj_c, xys, adj_i = wireless.poisson_graphs_from_dict(gdict)
    jadj_c, jxys, jadj_i = jwireless.poisson_graphs_from_dict(gdict)
    _same_sparse(adj_c, jadj_c)
    _same_sparse(adj_i, jadj_i)
    np.testing.assert_array_equal(xys, jxys)
    got = wireless.connection_graph_poisson(adj_c.toarray(), xys)
    want = jwireless.connection_graph_poisson(adj_c.toarray(), xys)
    _same_sparse(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    flows = wireless.flows_from_connectivity(adj_c)
    assert flows == jwireless.flows_from_connectivity(jadj_c)
    assert len(flows) == adj_i.shape[0]
    assert (adj_i != adj_i.T).nnz == 0 and adj_i.diagonal().sum() == 0


@pytest.mark.parametrize("name", ["0000", "0015"])
@pytest.mark.parametrize("k,p", [(2, 0.8), (3, 0.5)])
def test_multichannel_graphs_match_jax(name, k, p):
    gdict, seed = _gdict(name)
    adj_c, graphs = wireless.poisson_multigraphs_from_dict(
        gdict, k, p, np.random.default_rng(seed))
    jadj_c, jgraphs = jwireless.poisson_multigraphs_from_dict(
        gdict, k, p, np.random.default_rng(seed))
    _same_sparse(adj_c, jadj_c)
    for g, jg in zip(graphs, jgraphs):
        _same_sparse(g, jg)
    adj_i = wireless.poisson_graphs_from_dict(gdict)[2].toarray()
    sims = wireless.multichannel_conflict_simulate(
        adj_i, k, p, np.random.default_rng(seed))
    for g, jg in zip(sims, graphs):
        _same_sparse(g, jg)
    adj_list, adj_gk = wireless.multichannel_conflict_graph(graphs)
    jlist, jgk = jwireless.multichannel_conflict_graph(jgraphs)
    _same_sparse(adj_gk, jgk)
    for g, jg in zip(adj_list, jlist):
        _same_sparse(g, jg)
    nf = graphs[0].shape[0]
    # node ch*nf + link; the single-radio clique across a link's copies
    for i in range(nf):
        for c1 in range(k):
            for c2 in range(k):
                assert adj_gk[c1 * nf + i, c2 * nf + i] == (c1 != c2)
    for nfp in (nf, nf + 5, 128):
        got = wireless.pad_product_graph(adj_gk, nf, k, nfp)
        np.testing.assert_array_equal(
            got, jwireless.pad_product_graph(jgk, nf, k, nfp))
        blocks = got.reshape(k, nfp, k, nfp)
        assert not blocks[:, nf:].any() and not blocks[:, :, :, nf:].any()


# ---------------------------------------------------------- host engine


def test_traffic_streams_match_jax_global_rng():
    """One RandomState(treeseed) draws the stream of the reference's
    global np.random.seed(treeseed)."""
    for seed, n_ch in ((3, 1), (43013209, 3)):
        np.random.seed(seed)
        want_a = jsim.gen_arrivals(10, 50, 0.5, 0, 100)
        want_r = jsim.gen_link_rates(10, 50, n_ch, 0, 100)
        rs = np.random.RandomState(seed)
        np.testing.assert_array_equal(
            sim.gen_arrivals(10, 50, 0.5, 0, 100, rs), want_a)
        np.testing.assert_array_equal(
            sim.gen_link_rates(10, 50, n_ch, 0, 100, rs), want_r)


@pytest.mark.parametrize("wt_sel", ["qr", "q", "qor", "qrm", "random"])
def test_slot_weights_match_jax(wt_sel):
    rng = np.random.default_rng(1)
    q = np.floor(rng.random(12) * 30)
    r = np.floor(rng.random((12, 3)) * 100)
    r[0] = 0
    state = np.random.get_state()
    got = sim.slot_weights(q, r, wt_sel, seed=5007)
    # the port leaves numpy's global RNG alone
    assert all(np.array_equal(a, b) for a, b in
               zip(state[1:], np.random.get_state()[1:]))
    np.testing.assert_array_equal(
        got, jsim.slot_weights(q, r, wt_sel, seed=5007))


def test_algolist_and_opts_match_jax():
    assert sim.ALGO_BY_OPT == jsim.ALGO_BY_OPT
    for opt in range(8):
        for base in (False, True):
            assert sim.algolist_for_opt(opt, base) == \
                jsim.algolist_for_opt(opt, base)
    with pytest.raises(ValueError):
        sim.algolist_for_opt(42)


def _compare(got, want, exact_algos, gcn_algos):
    assert set(got) == set(want)
    for a in exact_algos:
        assert got[a] == want[a], a
    for a in gcn_algos:
        for k in METRICS:
            np.testing.assert_allclose(got[a][k], want[a][k], rtol=RTOL,
                                       err_msg=f"{a} {k}")


@pytest.mark.parametrize("wt_sel,load,treeseed", [
    ("qr", 0.5, None), ("qr", 0.9, None), ("random", 0.6, 7)])
def test_run_instance_matches_jax(wt_sel, load, treeseed):
    """poisson_net_0015 (28 links), T=30: Greedy, Greedy-Th and Benchmark
    identical; DGCN-LGS (the resident path) within rtol 1e-5. The random
    mode seeds each slot with treeseed * 1000 + t, which must stay below
    2**32, so it runs with a small tree seed (the network's own seed
    raises in both packages)."""
    gdict, seed = _gdict("0015")
    if treeseed is not None:
        for run, params in ((sim.run_instance, sim.SimParams),
                            (jsim.run_instance, jsim.SimParams)):
            with pytest.raises(ValueError, match="Seed"):
                run(np.zeros((2, 2)), 2, load, seed, ["Greedy"],
                    params(timeslots=3, wt_sel=wt_sel))
        seed = treeseed
    _, _, adj_i = wireless.poisson_graphs_from_dict(gdict)
    nflows = adj_i.shape[0]
    jag, tag = _agents()
    algos = ["Greedy", "Greedy-Th", "DGCN-LGS", "Benchmark"]
    got = sim.run_instance(adj_i, nflows, load, seed, algos,
                           sim.SimParams(timeslots=30, wt_sel=wt_sel),
                           agent=tag)
    want = jsim.run_instance(adj_i, nflows, load, seed, algos,
                             jsim.SimParams(timeslots=30, wt_sel=wt_sel),
                             agent=jag)
    _compare(got, want, ["Greedy", "Greedy-Th", "Benchmark"], ["DGCN-LGS"])
    for a in algos:
        assert 0 < got[a]["avg_utility"] <= 1.0 + 1e-9


def test_run_instance_greedy_benchmark_and_iterative_match_jax():
    """benchmark='greedy' (the native greedy baseline) with the agent's
    one-shot solve (no resident handle) and DIT, on poisson_net_0000."""
    gdict, seed = _gdict("0000")
    _, _, adj_i = wireless.poisson_graphs_from_dict(gdict)
    jag, tag = _agents(pad_to=128)
    algos = ["Greedy", "DGCN-LGS-it"]
    params = dict(timeslots=12, benchmark="greedy")
    got = sim.run_instance(adj_i, adj_i.shape[0], 0.7, 3, algos,
                           sim.SimParams(**params), agent=tag)
    want = jsim.run_instance(adj_i, adj_i.shape[0], 0.7, 3, algos,
                             jsim.SimParams(**params), agent=jag)
    _compare(got, want, ["Greedy"], ["DGCN-LGS-it"])
    # the one-shot solve (solve_mwis) where there is no resident handle
    runner = sim.AlgoRunner("DGCN-LGS", adj_i, sim.SimParams(**params))
    jrunner = jsim.AlgoRunner("DGCN-LGS", adj_i, jsim.SimParams(**params))
    runner.agent, jrunner.agent = tag, jag
    w = np.floor(np.random.default_rng(4).random(adj_i.shape[0]) * 500)
    mwis, u = runner.schedule(w, None, None)
    jmwis, ju = jrunner.schedule(w, None, None)
    assert mwis == jmwis
    np.testing.assert_allclose(u, ju, rtol=RTOL)


@pytest.mark.parametrize("algos", [["LGS-Seq", "Greedy"], ["DGCN-LGS-Seq"]])
def test_run_instance_multichannel_matches_jax(algos):
    """3 channels on poisson_net_0015's product graph (84 nodes): the
    sequential family and Greedy on the product graph."""
    gdict, seed = _gdict("0015")
    _, graphs = wireless.poisson_multigraphs_from_dict(
        gdict, 3, 0.8, np.random.default_rng(seed))
    adj_list, adj_gk = wireless.multichannel_conflict_graph(graphs)
    nflows = graphs[0].shape[0]
    jag, tag = _agents()
    params = dict(timeslots=20, n_ch=3, wt_sel="qr", benchmark="greedy")
    got = sim.run_instance(adj_gk, nflows, 0.8, seed, algos,
                           sim.SimParams(**params), agent=tag,
                           adj_list=adj_list)
    want = jsim.run_instance(adj_gk, nflows, 0.8, seed, algos,
                             jsim.SimParams(**params), agent=jag,
                             adj_list=adj_list)
    host = [a for a in algos if a != "DGCN-LGS-Seq"]
    _compare(got, want, host, [a for a in algos if a not in host])


def test_sequential_updates_the_queue_matrix_in_place():
    """_sequential writes each channel's drain estimate into the next
    column of the queue matrix it is given, as the JAX package does."""
    rng = np.random.default_rng(5)
    nf, n_ch = 20, 3
    chans = [random_graph(rng, n=nf, p=0.2) for _ in range(n_ch)]
    adj_list, adj_gk = wireless.multichannel_conflict_graph(chans)
    queue = np.floor(rng.random(nf) * 50 + 1)
    rates = np.trunc(rng.random((nf, n_ch)) * 99 + 1)
    q = np.tile(queue[:, None], (1, n_ch))
    jq = q.copy()
    params = dict(wt_sel="qr", n_ch=n_ch)
    got = sim.AlgoRunner("LGS-Seq", adj_gk, sim.SimParams(**params),
                         adj_list=adj_list, nflows=nf)._sequential(
        "LGS-Seq", q, rates)
    want = jsim.AlgoRunner("LGS-Seq", adj_gk, jsim.SimParams(**params),
                           adj_list=adj_list, nflows=nf)._sequential(
        "LGS-Seq", jq, rates)
    assert got == want
    np.testing.assert_array_equal(q, jq)
    assert (q[:, 1:] < q[:, :1]).any()


@pytest.mark.parametrize("loads", [[0.3, 0.6], [0.1, 0.30000000000000004]])
def test_results_csv_resumes_across_packages(tmp_path, loads):
    """A CSV written by the JAX package (pandas) resumes under the port
    and the reverse; `done` rounds the load to 2 places in both."""
    rows = [{"graph": 191664963, "seed": s, "load": ld, "name": name,
             "avg_degree": 13.123287671232877, "avg_queue_len": 1.5 + s,
             "med_queue_len": 0.25, "95p_queue_len": 7.0,
             "5p_queue_len": 0.0, "avg_utility": 0.9876543210987654}
            for s in (1, 2) for ld in loads
            for name in ("Greedy", "DGCN-LGS")]
    jres = jsim.ResumableResults(str(tmp_path / "jax.csv"))
    jres.append(rows[:4])
    port = sim.ResumableResults(str(tmp_path / "jax.csv"))
    assert port.rows == rows[:4]
    port.append(rows[4:])
    res = sim.ResumableResults(str(tmp_path / "port.csv"))
    res.append(rows[:4])
    res.append(rows[4:])
    # the port writes pandas' bytes: same file from either package
    jres.append(rows[4:])
    with open(tmp_path / "jax.csv") as f, open(tmp_path / "port.csv") as g:
        assert f.read() == g.read()
    back = jsim.ResumableResults(str(tmp_path / "port.csv"))
    # pandas' default float parser may miss the last bit of a float
    for got, want in zip(back.df.to_dict("records"), rows):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == (pytest.approx(v, rel=1e-15)
                              if isinstance(v, float) else v), k
    for r in (sim.ResumableResults(str(tmp_path / "port.csv")), back):
        for s in (1, 2):
            for ld in loads:
                assert r.done(191664963, s, round(ld, 2))
        assert not r.done(191664963, 3, loads[0])
        assert not r.done(1, 1, loads[0])


# --------------------------------------------------------- device loops


def _pinned(monkeypatch, arrivals):
    """Replace the arrival sampler of both packages by one fixed array."""
    def jax_factory(lam):
        return lambda key, shape, dtype=jnp.float32: \
            jnp.asarray(arrivals, dtype)

    def port_factory(lam):
        return lambda generator, shape, dtype=torch.float32: \
            torch.from_numpy(arrivals).to(dtype)

    monkeypatch.setattr(jdevice_sim, "make_poisson_arrivals", jax_factory)
    monkeypatch.setattr(device_sim, "make_poisson_arrivals", port_factory)


def _mc_batch(rng, b=3, nf=20, nfp=24, n_ch=3):
    """Padded product graphs [B, n_ch*nfp, n_ch*nfp], per-channel graphs
    [B, n_ch, nfp, nfp] and the link mask [B, nfp] (ragged link counts)."""
    gk = np.zeros((b, n_ch * nfp, n_ch * nfp), np.float32)
    ch = np.zeros((b, n_ch, nfp, nfp), np.float32)
    mask = np.zeros((b, nfp), bool)
    for i in range(b):
        n = nf - 3 * i
        chans = [random_graph(rng, n=n, p=0.2) for _ in range(n_ch)]
        _, adj_gk = wireless.multichannel_conflict_graph(chans)
        gk[i] = wireless.pad_product_graph(adj_gk, n, n_ch, nfp)
        for c in range(n_ch):
            ch[i, c, :n, :n] = chans[c].toarray()
        mask[i, :n] = True
    return gk, ch, mask


def _models(nodes, **kw):
    jag, tag = _agents(pad_to=nodes, **kw)
    return jag.model, jag.params, tag.model, jag.flags, tag.flags


@pytest.mark.parametrize("use_gcn,feature_mode,wt_sel", [
    (False, "gdpg", "qr"), (True, "gdpg", "qr"), (True, "dqn", "qr"),
    (True, "gdpg", "qrm"), (True, "dqn", "qor")])
def test_closed_loop_mc_matches_jax_with_pinned_draws(
        monkeypatch, use_gcn, feature_mode, wt_sel):
    rng = np.random.default_rng(11)
    n_ch, nfp = 3, 24
    gk, _, mask = _mc_batch(rng, nfp=nfp, n_ch=n_ch)
    arrivals = np.floor(rng.random(mask.shape) * 60).astype(np.float32)
    _pinned(monkeypatch, arrivals)
    jmodel, params, tmodel, jcfg, cfg = _models(n_ch * nfp)
    kw = dict(timeslots=25, n_ch=n_ch, load=0.7, rate_lo=40.0,
              rate_hi=40.0, wt_sel=wt_sel, feature_mode=feature_mode,
              use_gcn=use_gcn)
    jrun = jdevice_sim.make_closed_loop_mc(jmodel, jcfg, **kw)
    run = device_sim.make_closed_loop_mc(tmodel, cfg, **kw)
    jq, jm = jrun(params, jnp.asarray(gk), jnp.asarray(mask),
                  jnp.zeros(mask.shape), jax.random.PRNGKey(0))
    q, m = run(torch.from_numpy(gk), torch.from_numpy(mask),
               torch.zeros(mask.shape), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL)
    for k in ("avg_queue_len", "avg_utility", "sched_rate"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=RTOL, err_msg=k)
    assert (q.numpy()[~mask] == 0).all() and (q.numpy() >= 0).all()


@pytest.mark.parametrize("use_gcn,feature_mode", [
    (False, "gdpg"), (True, "gdpg"), (True, "dqn")])
def test_closed_loop_seq_matches_jax_with_pinned_draws(
        monkeypatch, use_gcn, feature_mode):
    """The JAX loop scores each channel on its whole channel graph, the
    port on the subgraph of the positive-utility links (ROADMAP §C, fault
    8). The two agree while no utility reaches 0, so the GCN cases pin at
    least 106 arrivals a slot on every link: above the 3 x 35 that the
    three channels can drain, no queue or drain estimate empties.
    Zero utilities go against the host engine
    (`test_closed_loop_seq_matches_the_host_engine_slot_for_slot`)."""
    rng = np.random.default_rng(12)
    n_ch, nfp = 3, 24
    _, ch, mask = _mc_batch(rng, nfp=nfp, n_ch=n_ch)
    arrivals = np.floor(rng.random(mask.shape) * 60).astype(np.float32)
    if use_gcn:
        arrivals += 106.0
    _pinned(monkeypatch, arrivals)
    jmodel, params, tmodel, jcfg, cfg = _models(nfp)
    kw = dict(timeslots=25, n_ch=n_ch, load=0.7, rate_lo=35.0, rate_hi=35.0,
              feature_mode=feature_mode, use_gcn=use_gcn)
    jrun = jdevice_sim.make_closed_loop_seq(jmodel, jcfg, **kw)
    run = device_sim.make_closed_loop_seq(tmodel, cfg, **kw)
    jq, jm = jrun(params, jnp.asarray(ch), jnp.asarray(mask),
                  jnp.zeros(mask.shape), jax.random.PRNGKey(0))
    q, m = run(torch.from_numpy(ch), torch.from_numpy(mask),
               torch.zeros(mask.shape), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL)
    for k in ("avg_queue_len", "avg_utility"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=RTOL, err_msg=k)


def test_jax_closed_loop_seq_scores_the_whole_channel_graph(monkeypatch):
    """ROADMAP §C fault 8: the JAX `make_closed_loop_seq` builds each
    channel's supports once over the link mask and scores the whole
    channel graph, where the published algorithm (the host engine's
    `_sequential`) deletes the zero-utility links and scores the subgraph
    left. On the pinned draws of the test above without the +106 (1 to 59
    arrivals a slot against 35 a channel, so a channel's drain estimate
    empties links and their utility on the next channel is 0), the
    DGCN-LGS-Seq episodes part: the port's final queues are the subgraph
    scoring's (the same loop with the whole-graph supports gives
    JAX's)."""
    rng = np.random.default_rng(12)
    n_ch, nfp = 3, 24
    _, ch, mask = _mc_batch(rng, nfp=nfp, n_ch=n_ch)
    arrivals = np.floor(rng.random(mask.shape) * 60).astype(np.float32)
    _pinned(monkeypatch, arrivals)
    jmodel, params, tmodel, jcfg, cfg = _models(nfp)
    kw = dict(timeslots=25, n_ch=n_ch, load=0.7, rate_lo=35.0, rate_hi=35.0)
    jq, _ = jdevice_sim.make_closed_loop_seq(jmodel, jcfg, **kw)(
        params, jnp.asarray(ch), jnp.asarray(mask), jnp.zeros(mask.shape),
        jax.random.PRNGKey(0))
    args = (torch.from_numpy(ch), torch.from_numpy(mask),
            torch.zeros(mask.shape), torch.Generator())
    q, _ = device_sim.make_closed_loop_seq(tmodel, cfg, **kw)(*args)
    real = device_sim.subgraph_supports
    monkeypatch.setattr(device_sim, "subgraph_supports",
                        lambda adj, keep, k, dtype: real(
                            adj, torch.ones_like(keep), k, dtype))
    whole, _ = device_sim.make_closed_loop_seq(tmodel, cfg, **kw)(*args)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jq), rtol=RTOL)
    assert not np.allclose(q.numpy(), np.asarray(jq), rtol=RTOL)
    print("fault 8: final queue sum, port (subgraph)", float(q.sum()),
          "JAX (whole graph)", float(np.asarray(jq).sum()))


def _slot_traffic(monkeypatch, slots):
    """The port's device loops draw each slot's (arrivals, rates) from
    `slots` in order."""
    it = iter(slots)
    monkeypatch.setattr(device_sim, "_traffic",
                        lambda *a: lambda generator, m, n_ch=None: next(it))


def _seq_draws(rng, mask, n_ch, t):
    """T slots of integer arrivals in [0, 40) and rates in [0, 60), a
    sixth of the rates 0, zero on padding."""
    m = torch.from_numpy(mask).to(torch.float32)
    out = []
    for _ in range(t):
        arr = np.floor(rng.random(mask.shape) * 40).astype(np.float32)
        rates = np.floor(rng.random(mask.shape + (n_ch,)) * 60)
        rates[rng.random(rates.shape) < 1 / 6] = 0
        out.append((torch.from_numpy(arr) * m,
                    torch.from_numpy(rates.astype(np.float32))
                    * m[..., None]))
    return out


@pytest.mark.parametrize("use_gcn,load", [(True, 0.3), (True, 0.9),
                                          (False, 0.6)])
def test_closed_loop_seq_matches_the_host_engine_slot_for_slot(
        monkeypatch, use_gcn, load):
    """The device loop's DGCN-LGS-Seq (LGS-Seq) against the host engine's
    `AlgoRunner._sequential`, which deletes each channel's zero-utility
    links and runs `agent.solve_mwis` on the subgraph left
    (wireless_dqn_test_mc.py:292-354): the same arrivals and rates, 30
    slots, one device slot a call from the queues of the last. Each slot
    schedules the same product nodes, and the queues are the same, with
    a link's capacity the sum of the rates of the channels it was
    scheduled on (the device loops' rule; the host engine's run_instance
    keeps only the last channel's rate, ROADMAP §C fault 9). Zero
    utilities are frequent: a sixth of the rates are 0, and a channel's
    drain estimate empties many links for the next."""
    rng = np.random.default_rng(24 if use_gcn else 25)
    n_ch, nfp, t = 3, 24, 30
    _, ch, mask = _mc_batch(rng, nfp=nfp, n_ch=n_ch)
    _, tag = _agents()
    slots = _seq_draws(rng, mask, n_ch, t)
    _slot_traffic(monkeypatch, slots)
    sels = []
    lgs = device_sim.batched_lgs

    def recording(adjb, w, m, *a):
        out = lgs(adjb, w, m, *a)
        sels.append((out[0] == 1).numpy())
        return out
    monkeypatch.setattr(device_sim, "batched_lgs", recording)
    run = device_sim.make_closed_loop_seq(tag.model, tag.flags, timeslots=1,
                                          n_ch=n_ch, load=load,
                                          use_gcn=use_gcn)
    name = "DGCN-LGS-Seq" if use_gcn else "LGS-Seq"
    runners = []
    for i in range(mask.shape[0]):
        nf = int(mask[i].sum())
        graphs = [sp.csr_matrix(ch[i, c, :nf, :nf]) for c in range(n_ch)]
        adj_list, adj_gk = wireless.multichannel_conflict_graph(graphs)
        runners.append((nf, sim.AlgoRunner(
            name, adj_gk, sim.SimParams(n_ch=n_ch), tag, adj_list, nf)))
    queue = torch.zeros(mask.shape)
    host_q = np.zeros(mask.shape)
    zero_links = 0
    for s, (arr, rates) in enumerate(slots):
        queue, _ = run(torch.from_numpy(ch), torch.from_numpy(mask), queue,
                       torch.Generator())
        device_sets = sels[-n_ch:]
        for i, (nf, runner) in enumerate(runners):
            q = host_q[i, :nf] + arr[i, :nf].numpy()
            r = rates[i, :nf].numpy().astype(np.float64)
            q_mtx = np.tile(q[:, None], (1, n_ch))
            want = runner._sequential(name, q_mtx, r)
            got = {c * nf + v for c in range(n_ch)
                   for v in np.nonzero(device_sets[c][i, :nf])[0].tolist()}
            assert got == want, (s, i)
            zero_links += int((q_mtx * r == 0).sum())
            cap = np.zeros(nf)
            for node in want:
                cap[node % nf] += r[node % nf, node // nf]
            host_q[i, :nf] = q - np.minimum(q, cap)
        np.testing.assert_array_equal(queue.numpy(), host_q)
    assert zero_links > 0


def test_host_engine_departs_the_last_channels_rate_only(monkeypatch):
    """ROADMAP §C fault 9, in both packages' host engines: run_instance
    sets a scheduled link's capacity to the rate of the last channel it
    was scheduled on (``capacity[links] = rates_flat[sched]``), where the
    device loops add the rates of all of them. One link, 100 packets, rates
    40 and 30 on two channels: LGS-Seq schedules it on both (its drain
    estimate 60 after channel 0); the device loop departs 70, the host
    engines 30."""
    arrivals = np.array([[0.0], [100.0]])
    rates = np.array([[[0, 0]], [[40, 30]]])
    for mod in (sim, jsim):
        monkeypatch.setattr(mod, "gen_arrivals", lambda *a: arrivals)
        monkeypatch.setattr(mod, "gen_link_rates", lambda *a: rates)
    one = sp.csr_matrix((1, 1))
    params = dict(timeslots=2, n_ch=2, wt_sel="qr")
    for mod in (sim, jsim):
        out = mod.run_instance(one, 1, 0.5, 0, ["LGS-Seq"],
                               mod.SimParams(**params), adj_list=[one, one])
        assert out["LGS-Seq"]["avg_queue_len"] == (0 + 70) / 2
    _slot_traffic(monkeypatch, [(torch.tensor([[100.0]]),
                                 torch.tensor([[[40.0, 30.0]]]))])
    run = device_sim.make_closed_loop_seq(None, Config(**BASE), timeslots=1,
                                          n_ch=2, use_gcn=False)
    q, _ = run(torch.ones((1, 2, 1, 1)) * 0, torch.ones((1, 1), dtype=bool),
               torch.zeros((1, 1)), torch.Generator())
    assert float(q[0, 0]) == 30.0


def test_closed_loop_mc_padding_inert_and_one_channel_per_link():
    """Random draws: queues finite, >= 0 and 0 on padding; in one slot on
    the product graph at most one channel per link fires, the schedule is
    independent and no padded product node is selected."""
    rng = np.random.default_rng(13)
    n_ch, nfp = 3, 24
    gk, _, mask = _mc_batch(rng, nfp=nfp, n_ch=n_ch)
    _, _, tmodel, _, cfg = _models(n_ch * nfp)
    for wt_sel in ("qr", "q", "random"):
        run = device_sim.make_closed_loop_mc(tmodel, cfg, timeslots=30,
                                             n_ch=n_ch, load=0.5,
                                             wt_sel=wt_sel)
        q, m = run(torch.from_numpy(gk), torch.from_numpy(mask),
                   torch.zeros(mask.shape), torch.Generator().manual_seed(1))
        assert torch.isfinite(q).all() and (q >= 0).all()
        assert (q[~torch.from_numpy(mask)] == 0).all()
        assert (m["avg_utility"] > 0).all()
    mask_k = torch.from_numpy(np.tile(mask, (1, n_ch)))
    adjb = torch.from_numpy(gk) > 0
    w = torch.rand(mask_k.shape, generator=torch.Generator().manual_seed(2))
    sel = batched_lgs(adjb, w * mask_k, mask_k)[0]
    on = sel == 1
    assert not (on & ~mask_k).any()
    assert int((on.reshape(-1, n_ch, nfp)).sum(dim=1).max()) <= 1
    assert not (adjb & on[:, :, None] & on[:, None, :]).any()


def test_closed_loop_mc_bfloat16_tracks_f32():
    """bf16 episodes (supports and params cast once) against f32, the
    product graph at load 0.9: mean avg_utility within 2%, as the JAX
    package's bf16 test holds its single-channel loop."""
    rng = np.random.default_rng(14)
    n_ch, nfp = 3, 24
    gk, _, mask = _mc_batch(rng, nfp=nfp, n_ch=n_ch)
    _, _, tmodel, _, cfg = _models(n_ch * nfp)
    out = {}
    for dt in ("float32", "bfloat16"):
        run = device_sim.make_closed_loop_mc(
            tmodel, cfg.replace(compute_dtype=dt), timeslots=50, n_ch=n_ch,
            load=0.9)
        q, m = run(torch.from_numpy(gk), torch.from_numpy(mask),
                   torch.zeros(mask.shape), torch.Generator().manual_seed(3))
        assert (q >= 0).all()
        out[dt] = float(m["avg_utility"].mean())
    assert abs(out["bfloat16"] - out["float32"]) <= 0.02 * out["float32"]


def test_closed_loop_mc_checks_the_product_graph_size():
    rng = np.random.default_rng(15)
    gk, _, mask = _mc_batch(rng, nfp=24, n_ch=3)
    _, _, tmodel, _, cfg = _models(72)
    run = device_sim.make_closed_loop_mc(tmodel, cfg, timeslots=2, n_ch=2)
    with pytest.raises(ValueError, match="product graph"):
        run(torch.from_numpy(gk), torch.from_numpy(mask),
            torch.zeros(mask.shape), torch.Generator())
