"""The wireless path on the card against the same path on the CPU.

Card tests (`-m cuda`; they skip without a card). This file imports only
the port, so it collects where flax is absent. On the card every LGS is
kernel B1; the CPU runs its plain version. The device loops pin their
draws as `tests/test_torch_wireless.py` does (constant rates, a fixed
arrival array), since a CUDA generator's stream is not the CPU's; whole
episodes then agree within rtol 1e-5 (f32 GCN scores agree to ~1e-6, B1 is
bit-equal to the plain LGS). Launch counts: 1 B1 launch a slot on the
product graph, n_ch a slot in the sequential loop, 2 a slot in the
single-channel loop with its greedy baseline, 1 a slot for the host
engine's resident DGCN-LGS.
"""

import os

import numpy as np
import pytest
import scipy.io as sio
import torch

from conftest import random_graph
from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.cli import wireless_sim
from distgcn_tpu_torch.data import wireless
from distgcn_tpu_torch.ops.lgs_cuda import batched_lgs_kernel
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.sim import wireless as sim
from distgcn_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "data", "wireless_test")
RTOL = 1e-5
CFG = dict(feature_size=1, hidden1=8, num_layer=3, diver_num=1,
           max_degree=1, predict="mwis", epsilon=0.0, pad_to=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(cuda, **kw):
    card = DQNAgent(Config(**dict(CFG, **kw)), model_family="gcn_dqn",
                    device=cuda)
    cpu = DQNAgent(Config(**dict(CFG, **kw)), model_family="gcn_dqn",
                   device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    return card, cpu


def _batch(rng, b=4, nf=40, nfp=64, n_ch=3):
    gk = np.zeros((b, n_ch * nfp, n_ch * nfp), np.float32)
    ch = np.zeros((b, n_ch, nfp, nfp), np.float32)
    mask = np.zeros((b, nfp), bool)
    for i in range(b):
        n = nf - 5 * i
        chans = [random_graph(rng, n=n, p=0.15) for _ in range(n_ch)]
        _, adj_gk = wireless.multichannel_conflict_graph(chans)
        gk[i] = wireless.pad_product_graph(adj_gk, n, n_ch, nfp)
        for c in range(n_ch):
            ch[i, c, :n, :n] = chans[c].toarray()
        mask[i, :n] = True
    return gk, ch, mask


def _pin(monkeypatch, arrivals):
    monkeypatch.setattr(
        device_sim, "make_poisson_arrivals",
        lambda lam: lambda generator, shape, dtype=torch.float32:
        torch.from_numpy(arrivals).to(generator.device, dtype))


def _episode(run, dev, *arrays, t):
    inputs = [torch.from_numpy(a).to(dev) for a in arrays]
    q0 = torch.zeros(arrays[-1].shape, device=dev)
    before = batched_lgs_kernel.launches
    q, m = run(*inputs, q0, torch.Generator(device=dev).manual_seed(0))
    return q.cpu(), {k: v.cpu() for k, v in m.items()}, \
        batched_lgs_kernel.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("feature_mode", ["gdpg", "dqn"])
def test_multichannel_loops_card_vs_cpu(cuda, monkeypatch, seq,
                                        feature_mode):
    rng = np.random.default_rng(20)
    n_ch, t = 3, 30
    gk, ch, mask = _batch(rng, n_ch=n_ch)
    _pin(monkeypatch, np.floor(rng.random(mask.shape) * 60)
         .astype(np.float32))
    graph = ch if seq else gk
    card, cpu = _pair(cuda, pad_to=graph.shape[-1])
    make = device_sim.make_closed_loop_seq if seq else \
        device_sim.make_closed_loop_mc
    kw = dict(timeslots=t, n_ch=n_ch, load=0.7, rate_lo=40.0, rate_hi=40.0,
              feature_mode=feature_mode)
    q, m, launches = _episode(make(card.model, card.flags, **kw), cuda,
                              graph, mask, t=t)
    cq, cm, _ = _episode(make(cpu.model, cpu.flags, **kw), "cpu", graph,
                         mask, t=t)
    assert launches == t * (n_ch if seq else 1)
    np.testing.assert_allclose(q.numpy(), cq.numpy(), rtol=RTOL)
    for k in cm:
        np.testing.assert_allclose(m[k].numpy(), cm[k].numpy(), rtol=RTOL,
                                   err_msg=k)
    assert (q.numpy()[~mask] == 0).all() and (q.numpy() >= 0).all()


@pytest.mark.cuda
def test_single_channel_loop_with_baseline_launches_twice_a_slot(cuda):
    rng = np.random.default_rng(21)
    _, ch, mask = _batch(rng, n_ch=1)
    card, _ = _pair(cuda, pad_to=64)
    run = device_sim.make_closed_loop(card.model, card.flags, timeslots=25,
                                      load=0.9, with_baseline=True)
    q, m, launches = _episode(run, cuda, ch[:, 0], mask, t=25)
    assert launches == 50
    assert torch.isfinite(q).all() and (q >= 0).all()
    assert ((m["avg_utility_ratio"] > 0) & (m["avg_utility_ratio"] < 2)).all()


@pytest.mark.cuda
def test_host_engine_card_vs_cpu(cuda):
    """run_instance on poisson_net_0015 with the agent on the card and on
    the CPU: host metrics identical, DGCN-LGS within rtol 1e-5, one B1
    launch a slot for the resident path."""
    m = sio.loadmat(os.path.join(NETS, "poisson_net_0015.mat"))
    seed = int(np.asarray(m["random_seed"]).flatten()[0])
    _, _, adj_i = wireless.poisson_graphs_from_dict(m["gdict"][0, 0])
    card, cpu = _pair(cuda)
    algos = ["Greedy", "DGCN-LGS", "Benchmark"]
    params = sim.SimParams(timeslots=40)
    before = batched_lgs_kernel.launches
    got = sim.run_instance(adj_i, adj_i.shape[0], 0.8, seed, algos, params,
                           agent=card)
    assert batched_lgs_kernel.launches - before == 39
    want = sim.run_instance(adj_i, adj_i.shape[0], 0.8, seed, algos, params,
                            agent=cpu)
    assert got["Greedy"] == want["Greedy"]
    assert got["Benchmark"] == want["Benchmark"]
    for k, v in want["DGCN-LGS"].items():
        np.testing.assert_allclose(got["DGCN-LGS"][k], v, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ch", [1, 3])
def test_device_loop_cli_on_the_card(cuda, tmp_path, n_ch):
    """main_device_loop over four of the repo's networks, one load: rows,
    queues and resume; the CSV in the JAX package's layout."""
    nets = tmp_path / "nets"
    nets.mkdir()
    for name in ("0006", "0009", "0015", "0018"):
        os.symlink(os.path.join(NETS, f"poisson_net_{name}.mat"),
                   nets / f"poisson_net_{name}.mat")
    argv = [f"--test_datapath={nets}", "--wt_sel=qr", "--load_min=0.6",
            "--load_max=0.6", "--load_step=1.0", f"--num_channels={n_ch}",
            "--num_layer=3", "--hidden1=8", "--feature_size=1",
            "--diver_num=1", "--max_degree=1", "--predict=mwis",
            f"--output={tmp_path}", "--device_loop=1",
            f"--model_root={tmp_path / 'nomodel'}"]
    before = batched_lgs_kernel.launches
    res = wireless_sim.main(argv)
    launches = batched_lgs_kernel.launches - before
    assert launches == wireless_sim.DEVICE_LOOP_SLOTS * (2 if n_ch == 1
                                                         else 1)
    assert len(res.rows) == 4
    assert all(r["avg_queue_len"] >= 0 and r["avg_utility"] > 0
               for r in res.rows)
    assert len(wireless_sim.main(argv).rows) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("opt,name", [(5, "DGCN-LGS-Seq-DL"),
                                      (7, "LGS-Seq-DL")])
def test_device_loop_cli_runs_the_sequential_loop_on_the_card(
        cuda, tmp_path, opt, name):
    """--device_loop=1 --num_channels=3 --opt=5 / 7 over four of the repo's
    networks: `make_closed_loop_seq`, 3 B1 launches a slot (one a
    channel), one row a network named for the algorithm."""
    nets = tmp_path / "nets"
    nets.mkdir()
    for net in ("0006", "0009", "0015", "0018"):
        os.symlink(os.path.join(NETS, f"poisson_net_{net}.mat"),
                   nets / f"poisson_net_{net}.mat")
    argv = [f"--test_datapath={nets}", "--wt_sel=qr", "--load_min=0.6",
            "--load_max=0.6", "--load_step=1.0", "--num_channels=3",
            f"--opt={opt}", "--num_layer=3", "--hidden1=8",
            "--feature_size=1", "--diver_num=1", "--max_degree=1",
            "--predict=mwis", f"--output={tmp_path}", "--device_loop=1",
            f"--model_root={tmp_path / 'nomodel'}"]
    before = batched_lgs_kernel.launches
    res = wireless_sim.main(argv)
    assert batched_lgs_kernel.launches - before == \
        3 * wireless_sim.DEVICE_LOOP_SLOTS
    assert len(res.rows) == 4 and {r["name"] for r in res.rows} == {name}
    assert all(r["avg_queue_len"] >= 0 and r["avg_utility"] > 0
               and r["avg_degree"] > 0 for r in res.rows)
