"""Port parity: the `wireless_sim` CLI end to end, the host engine
(`main`) and the device loop (`main_device_loop`), against the JAX
package on generated networks.

Both packages write their CSVs into `tmp_path`; each resumes the other's
(pandas on the JAX side, the `csv` module in the port). The host engine's
Greedy and Benchmark rows are identical and the DGCN-LGS rows within rtol
1e-5 (the agents hold the same parameters, carried over with
`params_from_jax`). Twin links (the same neighbours) get GCN scores that
are equal in exact arithmetic and differ by one unit in the last place,
computed per row by each package's own matmul; when their utilities also
tie, that bit picks the schedule, so no package is wrong. At load 0.5 it
happens on the second network in slot 194; the runs here, at load 0.6, see
no such slot. The device loop's traffic comes from each package's own
device RNG, so its rows are held to their layout and ranges, not to JAX's
values.
"""

import csv

import numpy as np
import pytest

from distgcn_tpu.agents import DQNAgent as JDQNAgent
from distgcn_tpu.cli import wireless_sim as jwireless_sim
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.cli import wireless_sim
from distgcn_tpu_torch.data import generate
from distgcn_tpu_torch.models.gcn import params_from_jax
from distgcn_tpu_torch.sim.wireless import ResumableResults
from distgcn_tpu_torch.utils.config import Config

RTOL = 1e-5
MODEL = dict(num_layer=2, hidden1=8, feature_size=1, diver_num=1,
             max_degree=1, predict="mwis")
FLAGS = [f"--{k}={v}" for k, v in MODEL.items()]
METRICS = ("avg_queue_len", "med_queue_len", "95p_queue_len",
           "5p_queue_len", "avg_utility")


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    d = tmp_path_factory.mktemp("nets")
    # 39 and 28 links, the size of the repo's smallest test networks: the
    # exact B&B proves every slot without its local-search phase (which
    # starts at 40 live nodes and spends a share of the timeout)
    n = generate.generate_wireless_network(str(d), n_networks=2, area=150,
                                           n_nodes=60, r_connect=1.0,
                                           r_interfere=3.0, seed=11)
    assert n == 2
    return d


def _agents():
    cfg = dict(MODEL, epsilon=0.0, pad_to=64)
    jag = JDQNAgent(JConfig(**cfg), model_family="gcn_dqn")
    tag = DQNAgent(Config(**cfg), model_family="gcn_dqn", device="cpu")
    tag.model.load_state_dict(params_from_jax(jag.params))
    return jag, tag


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def _key(row):
    return row["graph"], row["seed"], round(row["load"], 2), row["name"]


def _hold(rows, jrows, exact_names):
    """Port rows against JAX rows, matched by (graph, seed, load, name)."""
    want = {_key(r): r for r in jrows}
    assert sorted(_key(r) for r in rows) == sorted(want)
    for row in rows:
        jrow = want[_key(row)]
        assert row["avg_degree"] == jrow["avg_degree"]
        for k in METRICS:
            if row["name"] in exact_names:
                assert row[k] == jrow[k], (row["name"], k)
            else:
                np.testing.assert_allclose(row[k], jrow[k], rtol=RTOL,
                                           err_msg=f"{row['name']} {k}")


def test_main_host_engine_matches_jax_and_resumes_across(nets, tmp_path):
    """--opt=0: Greedy, DGCN-LGS (resident) and Benchmark (exact B&B) on
    two networks at one load, T=200."""
    jag, tag = _agents()
    argv = [f"--test_datapath={nets}", "--wt_sel=qr", "--load_min=0.6",
            "--load_max=0.6", "--load_step=1.0", "--num_channels=1",
            "--opt=0", *FLAGS, f"--model_root={tmp_path / 'nomodel'}"]
    port = [*argv, f"--output={tmp_path / 'p'}", "--device=cpu"]
    res = wireless_sim.main(port, agent=tag)
    jres = jwireless_sim.main([*argv, f"--output={tmp_path / 'j'}"],
                              agent=jag)
    assert len(res.rows) == 6
    _hold(res.rows, jres.df.to_dict("records"), ("Greedy", "Benchmark"))
    for row in res.rows:
        assert row["name"] == "Benchmark" or row["avg_utility"] <= 1 + 1e-9
    assert _header(res.path) == _header(jres.path)
    assert res.path.replace("/p/", "/j/") == jres.path
    # each resumes its own CSV and the other's with no new row
    assert len(wireless_sim.main(port, agent=tag).rows) == 6
    jport = [*argv, f"--output={tmp_path / 'j'}", "--device=cpu"]
    assert len(wireless_sim.main(jport, agent=tag).rows) == 6
    back = jwireless_sim.main([*argv, f"--output={tmp_path / 'p'}"],
                              agent=jag)
    assert len(back.df) == 6


def test_main_flood_and_train_match_jax(nets, tmp_path):
    """--flood=1 (load 0.85, instances 1..k as tree seeds) with the
    sequential LGS on one channel; --train=1 with the resident DGCN-LGS
    memorizes nothing in either package, so nothing is saved."""
    jag, tag = _agents()
    base = [f"--test_datapath={nets}", "--wt_sel=qr", "--num_channels=1",
            *FLAGS]
    argv = [*base, "--flood=1", "--instances=2", "--opt=7"]
    res = wireless_sim.main([*argv, f"--output={tmp_path / 'p'}",
                             "--device=cpu"])
    jres = jwireless_sim.main([*argv, f"--output={tmp_path / 'j'}"])
    assert len(res.rows) == 4 and res.path.endswith("_flood.csv")
    assert {r["seed"] for r in res.rows} == {1, 2}
    _hold(res.rows, jres.df.to_dict("records"), ("LGS-Seq",))
    argv = [*base, "--train=1", "--opt=0", "--benchmark=greedy",
            "--load_min=0.6", "--load_max=0.6", "--load_step=1.0",
            f"--model_root={tmp_path / 'model'}"]
    res = wireless_sim.main([*argv, f"--output={tmp_path / 'pt'}",
                             "--device=cpu"], agent=tag)
    jres = jwireless_sim.main([*argv, f"--output={tmp_path / 'jt'}"],
                              agent=jag)
    assert len(tag.memory) == len(jag.memory) == 0
    assert not (tmp_path / "model").exists()
    _hold(res.rows, jres.df.to_dict("records"), ("Greedy", "Benchmark"))


@pytest.mark.parametrize("n_ch", [1, 2])
def test_main_device_loop_rows_and_resume(nets, tmp_path, n_ch):
    """--device_loop=1 on the CPU: one row per network and load (T=200), in the
    JAX package's columns, queues >= 0, DGCN-LGS utility ratios (n_ch=1)
    or utilities (n_ch=2) > 0; a second run, and a run of the JAX package
    on the port's CSV, add no rows."""
    argv = [f"--test_datapath={nets}", "--wt_sel=qr", "--load_min=0.5",
            "--load_max=0.5", "--load_step=1.0", f"--num_channels={n_ch}",
            "--opt=0", *FLAGS, f"--output={tmp_path}", "--device_loop=1",
            f"--model_root={tmp_path / 'nomodel'}"]
    res = wireless_sim.main([*argv, "--device=cpu"])
    assert len(res.rows) == 2
    assert {r["name"] for r in res.rows} == {"DGCN-LGS-DL"}
    assert {r["load"] for r in res.rows} == {0.5}
    for r in res.rows:
        assert r["graph"] == r["seed"]
        assert r["avg_queue_len"] >= 0 and r["avg_utility"] > 0
        if n_ch == 1:
            assert r["avg_utility"] <= 1.5
    assert _header(res.path) == [""] + ResumableResults.COLS
    assert res.path.endswith(f"{n_ch}-channel_utility-qr_deviceloop.csv")
    assert len(wireless_sim.main([*argv, "--device=cpu"]).rows) == 2
    assert len(jwireless_sim.main(argv).df) == 2


def test_pack_networks_pads_links_to_the_bucket(nets):
    """Every network in one batch: links padded to 128, the product graph
    re-blocked per channel for n_ch > 1, padding rows and columns zero;
    the per-channel graphs are the product graph's diagonal blocks."""
    for n_ch in (1, 3):
        cfg = Config(test_datapath=str(nets), num_channels=n_ch)
        found, adj, mask, adj_ch = wireless_sim.pack_networks(cfg)
        assert len(found) == 2 and mask.shape == (2, 128)
        assert adj.shape == (2, 128 * n_ch, 128 * n_ch)
        assert adj_ch.shape == (2, n_ch, 128, 128)
        for c in range(n_ch):
            np.testing.assert_array_equal(
                adj_ch[:, c], adj[:, c * 128:(c + 1) * 128,
                                  c * 128:(c + 1) * 128])
        for i, (_, nf) in enumerate(found):
            assert mask[i].sum() == nf
            blocks = adj[i].reshape(n_ch, 128, n_ch, 128)
            assert not blocks[:, nf:].any() and not blocks[:, :, :, nf:].any()
            assert (blocks[:, :nf, :, :nf] == blocks[:, :nf, :, :nf]
                    .transpose(2, 3, 0, 1)).all()


@pytest.mark.parametrize("opt,name", [(5, "DGCN-LGS-Seq-DL"),
                                      (7, "LGS-Seq-DL")])
def test_main_device_loop_runs_the_sequential_loop(nets, tmp_path,
                                                   monkeypatch, opt, name):
    """--device_loop=1 --num_channels=3 with --opt=5 or --opt=7 runs
    `make_closed_loop_seq` on the per-channel graphs: 3 LGS launches a
    slot (one a channel), one row a network named for the algorithm, its
    avg_degree the host engine's (the channel graphs' mean degree)."""
    from distgcn_tpu_torch.sim import device_sim
    calls = []
    lgs = device_sim.batched_lgs

    def counting(adjb, w, mask, *a):
        calls.append(tuple(adjb.shape))
        return lgs(adjb, w, mask, *a)
    monkeypatch.setattr(device_sim, "batched_lgs", counting)
    argv = [f"--test_datapath={nets}", "--wt_sel=qr", "--load_min=0.6",
            "--load_max=0.6", "--load_step=1.0", "--num_channels=3",
            f"--opt={opt}", *FLAGS, f"--output={tmp_path}",
            "--device_loop=1", f"--model_root={tmp_path / 'nomodel'}",
            "--device=cpu"]
    res = wireless_sim.main(argv)
    assert calls == [(2, 128, 128)] * (3 * wireless_sim.DEVICE_LOOP_SLOTS)
    assert len(res.rows) == 2 and {r["name"] for r in res.rows} == {name}
    cfg = Config(test_datapath=str(nets), num_channels=3)
    found, _, _, adj_ch = wireless_sim.pack_networks(cfg)
    for r, (seed, nf), graphs in zip(res.rows, found, adj_ch):
        assert r["graph"] == seed and r["load"] == 0.6
        assert r["avg_queue_len"] >= 0 and r["avg_utility"] > 0
        degs = [np.asarray(g[:nf, :nf].sum(1), np.float64).mean()
                for g in graphs]
        assert r["avg_degree"] == float(np.mean(degs)) > 0


def test_main_device_loop_routes_by_opt_and_rejects_cgcn_rs_seq(nets):
    """`device_loop`: the product graph for any other opt, the single
    channel loop for one channel; --opt=6 (CGCN-RS-Seq) has no device
    loop and says so before any network is loaded."""
    _, tag = _agents()
    for n_ch, opt, name, per_channel in ((3, 0, "DGCN-LGS-DL", False),
                                        (3, 5, "DGCN-LGS-Seq-DL", True),
                                        (1, 5, "DGCN-LGS-DL", False),
                                        (1, 0, "DGCN-LGS-DL", False)):
        got = wireless_sim.device_loop(tag.model, tag.flags, n_ch, opt, 0.5)
        assert (got[0], got[2]) == (name, per_channel)
    for n_ch in (1, 3):
        with pytest.raises(ValueError, match="CGCN-RS-Seq"):
            wireless_sim.device_loop(tag.model, tag.flags, n_ch, 6, 0.5)
    argv = [f"--test_datapath={nets}", "--num_channels=3", "--opt=6",
            *FLAGS, "--device_loop=1", "--device=cpu",
            "--output=/nonexistent/never-written"]
    with pytest.raises(ValueError, match="CGCN-RS-Seq"):
        wireless_sim.main(argv, agent=tag)
    with pytest.raises(ValueError, match="wt_sel"):
        wireless_sim.device_loop(tag.model, tag.flags, 3, 7, 0.5, "q")
