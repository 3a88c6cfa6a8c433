"""The trainer paths on the card against the same paths on the CPU.

Card tests (`-m cuda`; they skip without a card). This file imports only
the port, so it collects where flax is absent. On the card every solve's
LGS is kernel B1; the CPU runs its plain version. Tolerances: selections
bit-equal (B1 is bit-equal to the plain LGS and the f32 scores agree to
~1e-6), losses within rtol 1e-4, parameters after K per-sample TF1 Adam
steps within 2·lr·K + rtol 1e-4 (tests/test_torch_agents.py gives the
bound's reason).
"""

import numpy as np
import pytest
import torch

from conftest import random_graph
from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.ops.lgs_cuda import batched_lgs_kernel
from distgcn_tpu_torch.pipeline import make_train_pipeline
from distgcn_tpu_torch.rl.train import make_optimizer
from distgcn_tpu_torch.sim.device_sim import make_online_train_step
from distgcn_tpu_torch.solvers.greedy import greedy_search
from distgcn_tpu_torch.utils.config import Config

LR = 1e-3
CFG = dict(feature_size=1, hidden1=8, num_layer=3, diver_num=1,
           max_degree=1, predict="mwis", epsilon=0.0, pad_to=64,
           learning_rate=LR)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(cuda, family="gcn2_dqn"):
    card = DQNAgent(Config(**CFG), model_family=family, device=cuda)
    cpu = DQNAgent(Config(**CFG), model_family=family, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    return card, cpu


def _graphs(rng, k=6):
    out = []
    for _ in range(k):
        n = int(rng.integers(20, 64))
        out.append((random_graph(rng, n, 0.1), rng.random(n)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gcn_dqn", "gcn2_dqn"])
def test_agent_solve_and_replay_on_card_match_cpu(cuda, rng, family):
    card, cpu = _pair(cuda, family)
    before = batched_lgs_kernel.launches
    for a, w in _graphs(rng):
        grd = greedy_search(a, w)[1]
        assert card.solve_mwis(a, w, train=True, grd=grd) == \
            cpu.solve_mwis(a, w, train=True, grd=grd)
    assert batched_lgs_kernel.launches - before == 6
    minibatch = list(card.memory)
    losses = card.trainer.step(*card.trainer.prepare(minibatch))
    closses = cpu.trainer.step(*cpu.trainer.prepare(minibatch))
    torch.testing.assert_close(losses.cpu(), closses, rtol=1e-4, atol=0)
    want = cpu.model.state_dict()
    for k, v in card.model.state_dict().items():
        torch.testing.assert_close(v.cpu(), want[k], rtol=1e-4,
                                   atol=2 * LR * len(minibatch))


@pytest.mark.cuda
def test_train_pipeline_on_card_matches_cpu(cuda, rng):
    card, cpu = _pair(cuda)
    inst = _graphs(rng, 8)
    args = {}
    for dev in (cuda, torch.device("cpu")):
        gb = GraphBatch.from_scipy([a for a, _ in inst], [w for _, w in inst],
                                   pad_to=64, device=dev)
        rand = torch.from_numpy(np.random.default_rng(1).random(
            (8, 64)).astype(np.float32)).to(dev)
        explore = (torch.arange(8) % 3 == 0).to(dev)
        args[dev.type] = (gb.adj, gb.wts, gb.mask, rand, explore)
    before = batched_lgs_kernel.launches
    got = make_train_pipeline(card.model, card.flags)(*args["cuda"])
    assert batched_lgs_kernel.launches - before == 2
    want = make_train_pipeline(cpu.model, cpu.flags)(*args["cpu"])
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_online_train_step_on_card_matches_cpu(cuda, rng):
    card, cpu = _pair(cuda)
    inst = _graphs(rng, 4)
    opt = make_optimizer(LR)
    runs = {}
    for agent in (card, cpu):
        dev = agent.device
        gb = GraphBatch.from_scipy([a for a, _ in inst], [w for _, w in inst],
                                   pad_to=64, device=dev)
        sup = prep.masked_simple_polynomials_dense(gb.adj, gb.mask, 1)
        step = make_online_train_step(agent.model, agent.flags, opt)
        state = opt.init(dict(agent.model.named_parameters()))
        queue = torch.zeros((4, 64), device=dev)
        draws = np.random.default_rng(2)
        slots = []
        for _ in range(3):
            m = gb.mask.cpu().numpy()
            arrivals = torch.from_numpy(draws.poisson(10.0, m.shape).astype(
                np.float32) * m).to(dev)
            rates = torch.from_numpy(np.clip(np.trunc(draws.normal(
                50, 25, m.shape)), 0, 100).astype(np.float32) * m).to(dev)
            before = batched_lgs_kernel.launches
            state, queue, slot = step(state, sup, gb.adj > 0, gb.mask,
                                      queue, arrivals, rates)
            if dev.type == "cuda":
                assert batched_lgs_kernel.launches - before == 2
            slots.append((float(slot["loss"]), queue.cpu()))
        runs[dev.type] = slots
    for (gl, gq), (wl, wq) in zip(runs["cuda"], runs["cpu"]):
        assert gl == pytest.approx(wl, rel=1e-4)
        torch.testing.assert_close(gq, wq, rtol=1e-5, atol=1e-3)
