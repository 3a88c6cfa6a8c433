"""Port parity: the graph-set evaluation CLI (`eval_graphs.main` and its
rollout sweep `rollout_main`) and the `train_dqn` / `train_diver` CLIs
against the JAX package's, on tiny datasets generated into `tmp_path`.

Both packages read the same checkpoint (written by a JAX agent into a
temporary model root). The CSVs must have the same rows, p within
rtol 1e-5; a sweep that one package wrote resumes under the other (rows
with p == 0 are tried again, files added since get rows, rows of vanished
files are dropped). The trainers run one short epoch with `--device=cpu`;
`train_diver` is held against the JAX CLI (the best ratio within rtol 1e-5,
the saved params within 2·lr + rtol 1e-4).
"""

import os

import numpy as np
import pandas as pd
import pytest

from distgcn_tpu import agents_extra as jextra
from distgcn_tpu.agents import DQNAgent as JDQNAgent
from distgcn_tpu.cli import eval_graphs as jeval
from distgcn_tpu.cli import train_diver as jtrain_diver
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu.utils.serialization import load_params as jload_params
from distgcn_tpu_torch.agents_extra import LegacyDQNAgent
from distgcn_tpu_torch.cli import eval_graphs, train_diver, train_dqn
from distgcn_tpu_torch.data.generate import generate_graph_dataset
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.serialization import load_params

MODEL = dict(feature_size=1, hidden1=8, num_layer=2, max_degree=1,
             predict="mwis")
ARGS = ["--feature_size=1", "--hidden1=8", "--num_layer=2",
        "--max_degree=1", "--predict=mwis", "--pad_to=64", "--epsilon=0"]


@pytest.fixture
def data(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTGCN_PACK_CACHE", str(tmp_path / "packs"))
    for sub, seed in (("train", 1), ("test", 2)):
        generate_graph_dataset(str(tmp_path / sub), "ER", sizes=(20, 40, 60),
                               ps=(0.1, 0.2), n_per_config=1, seed=seed,
                               label=True)
    return tmp_path


def _jax_cfg(**kw):
    return JConfig(**dict(MODEL, **kw))


def _rows(path):
    df = pd.read_csv(path, index_col=0)
    return list(df["data"]), df["p"].to_numpy()


def test_eval_graphs_main_matches_jax(data):
    jag = JDQNAgent(_jax_cfg(diver_num=1, training_set="EVT"),
                    model_family="gcn_dqn", seed=4)
    jag.save(os.path.join(data, "model",
                          "result_EVT_deep_ld1_c8_l2_cheb1_diver1_mwis_dqn"))
    argv = ARGS + [f"--datapath={data}/test", "--training_set=EVT",
                   "--diver_num=1", f"--model_root={data}/model",
                   "--batch_size=4"]
    jmean = jeval.main(argv + [f"--output_dir={data}/jout"])
    tmean = eval_graphs.main(argv + [f"--output_dir={data}/tout",
                                     "--device=cpu"])
    assert tmean == pytest.approx(jmean, rel=1e-5)
    name = "result_EVT_deep_ld1_c8_l2_cheb1_diver1_mwis_dqn_test.csv"
    jnames, jp = _rows(os.path.join(data, "jout", name))
    tnames, tp = _rows(os.path.join(data, "tout", name))
    assert tnames == jnames and len(tnames) == 6
    np.testing.assert_allclose(tp, jp, rtol=1e-5)
    with open(os.path.join(data, "tout", name)) as f:
        assert f.readline().strip() == ",data,p"


def _diver_model(data, training_set="RST"):
    jag = jextra.DiverAgent(_jax_cfg(diver_num=4, training_set=training_set),
                            seed=5)
    folder = os.path.join(
        data, "model",
        f"result_{training_set}_deep_ld1_c8_l2_cheb1_diver4_mwis_diver")
    jag.save(folder)
    return folder


ROLLOUT = ["--rollout=1", "--training_set=RST", "--diver_num=4",
           "--max_pops=6", "--batch_pops=3", "--group=2",
           "--backoff_prob=0.6"]


def test_rollout_main_matches_jax_and_resumes_across_packages(data):
    _diver_model(data)
    argv = ARGS + ROLLOUT + [f"--datapath={data}/test",
                             f"--model_root={data}/model"]
    name = "result_RST_deep_ld1_c8_l2_cheb1_diver4_mwis_diver_rs6_test.csv"
    jmean = jeval.main(argv + [f"--output_dir={data}/jout"])
    tmean = eval_graphs.main(argv + [f"--output_dir={data}/tout",
                                     "--device=cpu"])
    assert tmean == pytest.approx(jmean, rel=1e-5)
    jcsv, tcsv = (os.path.join(data, d, name) for d in ("jout", "tout"))
    jnames, jp = _rows(jcsv)
    tnames, tp = _rows(tcsv)
    assert tnames == jnames and (tp > 0).all()
    np.testing.assert_allclose(tp, jp, rtol=1e-5)

    # a JAX-written CSV with two rows to redo, a file gone and a file
    # added resumes under each package alike
    df = pd.read_csv(jcsv, index_col=0)
    df.loc[[1, 4], "p"] = 0.0
    gone = jnames[2]
    os.rename(os.path.join(data, "test", gone), os.path.join(data, gone))
    generate_graph_dataset(str(data / "extra"), "ER", sizes=(30,), ps=(0.15,),
                           n_per_config=1, seed=9, label=False)
    new = os.listdir(data / "extra")[0]
    os.rename(os.path.join(data, "extra", new),
              os.path.join(data, "test", "ZZ_" + new))
    for d in ("jres", "tres"):
        os.makedirs(os.path.join(data, d))
        df.to_csv(os.path.join(data, d, name))
    jeval.main(argv + [f"--output_dir={data}/jres"])
    eval_graphs.main(argv + [f"--output_dir={data}/tres", "--device=cpu"])
    jn, jp2 = _rows(os.path.join(data, "jres", name))
    names, p = _rows(os.path.join(data, "tres", name))
    assert names == jn
    assert names == [x for x in jnames if x != gone] + ["ZZ_" + new]
    assert (p > 0).all()
    np.testing.assert_allclose(p, jp2, rtol=1e-5)
    kept = [i for i, x in enumerate(jnames) if x not in (gone, jnames[1],
                                                         jnames[4])]
    np.testing.assert_array_equal(
        [p[names.index(jnames[i])] for i in kept], jp[kept])

    # a port-written CSV resumes under the JAX package as under the port
    rows = eval_graphs.read_csv(os.path.join(data, "tres", name))
    rows[0] = (rows[0][0], 0.0)
    for d in ("jres", "tres"):
        eval_graphs.write_csv(os.path.join(data, d, name), rows)
    jeval.main(argv + [f"--output_dir={data}/jres"])
    eval_graphs.main(argv + [f"--output_dir={data}/tres", "--device=cpu"])
    jn, jp3 = _rows(os.path.join(data, "jres", name))
    tn, tp3 = _rows(os.path.join(data, "tres", name))
    assert jn == tn == names and (tp3 > 0).all()
    np.testing.assert_allclose(tp3, jp3, rtol=1e-5)
    np.testing.assert_array_equal(tp3[1:], p[1:])


def test_csv_layout_round_trips_with_pandas(tmp_path):
    rows = [("a.mat", 1.0), ("b.mat", 1 / 3), ("c.mat", 0.0)]
    path = str(tmp_path / "x.csv")
    eval_graphs.write_csv(path, rows)
    df = pd.read_csv(path, index_col=0)
    assert list(df["data"]) == ["a.mat", "b.mat", "c.mat"]
    assert list(df["p"]) == [1.0, 1 / 3, 0.0]
    df.to_csv(path)
    assert eval_graphs.read_csv(path) == rows


def test_train_dqn_runs_one_short_epoch(data, capsys):
    argv = ARGS + [f"--datapath={data}/train", f"--test_datapath={data}/test",
                   "--training_set=TDQ", "--diver_num=1", "--epochs=1",
                   f"--model_root={data}/model", "--replay_every=3",
                   "--replay_batch=3", "--learning_rate=1e-3",
                   "--epsilon=0.5", "--device=cpu"]
    agent = LegacyDQNAgent(Config.from_args(argv), device="cpu")
    before = {k: v.clone() for k, v in agent.model.state_dict().items()}
    best = train_dqn.main(argv, agent=agent, max_graphs_per_epoch=6)
    assert np.isfinite(best) and best >= 0.55
    out = capsys.readouterr().out
    losses = [float(line.split("Loss: ")[1].split()[0])
              for line in out.splitlines() if "Loss: " in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any(not np.array_equal(v.numpy(), before[k].numpy())
               for k, v in agent.model.state_dict().items())
    assert len(agent.memory) == 6     # the legacy replay keeps its memory


def test_train_diver_matches_jax(data, capsys):
    _diver_model(data, "TDV")
    lr = 1e-3
    argv = ARGS + [f"--datapath={data}/train", f"--test_datapath={data}/test",
                   "--training_set=TDV", "--diver_num=4", "--epochs=1",
                   "--device_batch=4", f"--learning_rate={lr}",
                   "--backoff_prob=0.0"]
    folder = "result_TDV_deep_ld1_c8_l2_cheb1_diver4_mwis_diver"
    before = load_params(os.path.join(data, "model", folder, "params.npz"))
    jbest = jtrain_diver.main(argv + [f"--model_root={data}/model"])
    jparams = jload_params(os.path.join(data, "model", folder, "params.npz"))
    os.makedirs(os.path.join(data, "tmodel", folder))
    np.savez(os.path.join(data, "tmodel", folder, "params.npz"),
             **{f"{layer}::{k}": v for layer, leaves in before.items()
                for k, v in leaves.items()})
    tbest = train_diver.main(argv + [f"--model_root={data}/tmodel",
                                     "--device=cpu"])
    assert tbest == pytest.approx(jbest, rel=1e-5)
    losses = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith("Epoch: 0 Loss: ")]
    assert len(losses) == 2
    jl, tl = (float(x.split("Loss: ")[1].split()[0]) for x in losses)
    assert np.isfinite(tl) and tl == pytest.approx(jl, rel=1e-4)
    tparams = load_params(os.path.join(data, "tmodel", folder, "params.npz"))
    moved = False
    for layer, leaves in jparams.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(tparams[layer][k], v, rtol=1e-4,
                                       atol=2 * lr)
            moved |= not np.array_equal(tparams[layer][k],
                                        before[layer][k])
    assert moved
