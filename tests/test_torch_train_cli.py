"""Port parity: the `train_gdpg` CLI and the port's own copies of the JAX
package's host modules (`data/generate`, `data/matio`, `solvers/greedy`,
`utils/directory`, `compat/tf1_ckpt`).

The copies must give the same files and arrays as the JAX package's for
the same seed (equal, not close). The CLI runs end to end with
`--device=cpu` on tiny generated datasets and writes only under the
temporary model root and pack cache it is given.
"""

import os

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

from conftest import random_graph
from distgcn_tpu.cli import train_gdpg as jcli
from distgcn_tpu.compat import tf1_ckpt as jtf1
from distgcn_tpu.data import generate as jgen
from distgcn_tpu.data import matio as jmatio
from distgcn_tpu.solvers import greedy as jgreedy
from distgcn_tpu.utils import directory as jdirectory
from distgcn_tpu.utils.config import Config as JConfig
from distgcn_tpu.utils.serialization import load_params as jload_params
from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.cli import train_gdpg
from distgcn_tpu_torch.compat import tf1_ckpt
from distgcn_tpu_torch.data import generate, matio
from distgcn_tpu_torch.solvers import greedy
from distgcn_tpu_torch.utils import directory
from distgcn_tpu_torch.utils.config import Config


def _mat_equal(a, b):
    ma, mb = sio.loadmat(a), sio.loadmat(b)
    keys = sorted(k for k in ma if not k.startswith("__"))
    assert keys == sorted(k for k in mb if not k.startswith("__"))
    for k in keys:
        va, vb = ma[k], mb[k]
        if sp.issparse(va):
            assert (va != vb).nnz == 0, k
        elif va.dtype.names:     # matlab struct (gdict)
            for f in va.dtype.names:
                np.testing.assert_array_equal(va[f][0, 0], vb[f][0, 0])
        else:
            np.testing.assert_array_equal(va, vb, err_msg=k)


@pytest.mark.parametrize("graph_type", ["ER", "BA", "ppp"])
def test_generate_graph_dataset_writes_jax_files(tmp_path, graph_type):
    kw = dict(graph_type=graph_type, sizes=(20, 30), ps=(0.1, 0.2),
              n_per_config=2, seed=5, label=True)
    assert generate.generate_graph_dataset(str(tmp_path / "t"), **kw) == \
        jgen.generate_graph_dataset(str(tmp_path / "j"), **kw)
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == files
    for f in files:
        _mat_equal(tmp_path / "t" / f, tmp_path / "j" / f)


def test_generate_helpers_and_wireless_networks_match_jax(tmp_path):
    for dist in ("uniform", "normal_l1", "normal_l2"):
        np.testing.assert_array_equal(
            generate.sample_weights(17, dist, rng=np.random.default_rng(1)),
            jgen.sample_weights(17, dist, rng=np.random.default_rng(1)))
    a = generate.er_graph(30, 0.2, np.random.default_rng(2))
    assert (a != jgen.er_graph(30, 0.2, np.random.default_rng(2))).nnz == 0
    w = np.random.default_rng(3).random(30)
    assert generate.label_instance(a, w, np.random.default_rng(4)) == \
        jgen.label_instance(a, w, np.random.default_rng(4))
    # exact labels: the port's own native B&B, equal to JAX's
    assert generate.label_instance(a, w, exact=True) == \
        jgen.label_instance(a, w, exact=True)
    assert generate.generate_wireless_network(
        str(tmp_path / "t"), n_networks=2, area=30.0, n_nodes=12, seed=6) == \
        jgen.generate_wireless_network(
            str(tmp_path / "j"), n_networks=2, area=30.0, n_nodes=12, seed=6)
    for f in sorted(os.listdir(tmp_path / "j")):
        _mat_equal(tmp_path / "t" / f, tmp_path / "j" / f)


def test_matio_reads_packs_and_lists_as_jax(tmp_path, monkeypatch):
    generate.generate_graph_dataset(str(tmp_path / "d"), sizes=(20, 25),
                                    ps=(0.1,), n_per_config=3, seed=7)
    d = str(tmp_path / "d")
    assert matio.list_dataset(d) == jmatio.list_dataset(d)
    f = matio.list_dataset(d)[0]
    assert (matio.extract_n(f), matio.extract_np(f)) == (
        jmatio.extract_n(f), jmatio.extract_np(f))
    monkeypatch.setenv("DISTGCN_PACK_CACHE", str(tmp_path / "packs"))
    for pair in ((matio.load_mat(os.path.join(d, f)),
                  jmatio.load_mat(os.path.join(d, f))),
                 *zip(matio.load_dataset_cached(d),
                      jmatio.load_dataset_cached(d))):
        t, j = pair
        assert (t.adj != j.adj).nnz == 0 and t.name == j.name
        for attr in ("weights", "mwis_label"):
            np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr))
        assert (t.mwis_utility, t.greedy_utility) == (j.mwis_utility,
                                                      j.greedy_utility)
    assert matio._pack_path(d, matio.list_dataset(d)) == \
        jmatio._pack_path(d, jmatio.list_dataset(d))


@pytest.mark.parametrize("fn", ["greedy_search", "local_greedy_search",
                                "local_greedy_search_count",
                                "local_greedy_search_stats",
                                "local_greedy_search_overhead",
                                "dist_greedy_search"])
def test_greedy_solvers_match_jax(rng, fn):
    for _ in range(3):
        a = random_graph(rng, 40, 0.1)
        w = rng.random(40)
        got, want = getattr(greedy, fn)(a, w), getattr(jgreedy, fn)(a, w)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g, j)
    a, w = random_graph(rng, 40, 0.1), rng.random(40)
    assert greedy.local_greedy_search_nstep(a, w, 2) == \
        jgreedy.local_greedy_search_nstep(a, w, 2)


def test_directory_names_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kw = dict(training_set="ERGDPG2", num_layer=20, feature_size=1,
              diver_num=1, snapshot="s1", datapath="/x/ER_test")
    assert directory.find_model_folder(Config(**kw), "dqn", "root") == \
        jdirectory.find_model_folder(JConfig(**kw), "dqn", "root")
    for greedy_mode in (0, 1, 2):
        kw.update(greedy=greedy_mode)
        assert directory.create_result_folder(Config(**kw), "p") == \
            jdirectory.create_result_folder(JConfig(**kw), "p")


def test_tf1_importer_helpers_match_jax(tmp_path):
    tree = jload_params(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "model",
        "result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn",
        "params.npz"))
    assert tf1_ckpt.infer_architecture(tree) == jtf1.infer_architecture(tree)
    with open(tmp_path / "checkpoint", "w") as f:
        f.write('model_checkpoint_path: "model.ckpt-7"\n')
    assert tf1_ckpt.latest_checkpoint(str(tmp_path)) == \
        jtf1.latest_checkpoint(str(tmp_path))
    for mod in (tf1_ckpt, jtf1):
        with pytest.raises(FileNotFoundError):
            mod.load_tf1_gcn_params(str(tmp_path / "missing"))


@pytest.mark.parametrize("start_epoch", [0, 4, 5, 12, 20, 24])
def test_schedule_epsilon_matches_jax(start_epoch):
    assert train_gdpg.schedule_epsilon(start_epoch) == \
        jcli.schedule_epsilon(start_epoch)


def _datasets(root):
    generate.generate_graph_dataset(str(root / "train"), sizes=(20, 30),
                                    ps=(0.1, 0.2), n_per_config=3, seed=1,
                                    label=False)
    generate.generate_graph_dataset(str(root / "test"), sizes=(25,),
                                    ps=(0.1,), n_per_config=3, seed=2)
    return [f"--datapath={root / 'train'}", f"--test_datapath={root / 'test'}",
            f"--model_root={root / 'models'}", "--training_set=ERTINY",
            "--num_layer=2", "--hidden1=8", "--feature_size=1",
            "--diver_num=1", "--learning_rate=1e-3", "--epochs=2",
            "--pad_to=32", "--replay_every=4", "--replay_batch=4",
            "--epsilon=1.0", "--device=cpu"]


@pytest.mark.parametrize("batched", [False, True])
def test_train_gdpg_runs_on_the_cpu_and_writes_under_its_model_root(
        tmp_path, monkeypatch, capsys, batched):
    monkeypatch.setenv("DISTGCN_PACK_CACHE", str(tmp_path / "packs"))
    argv = _datasets(tmp_path) + (["--device_batch=5"] if batched else [])
    cfg = Config.from_args(argv)
    agent = DQNAgent(cfg, device="cpu")
    before = {k: v.clone() for k, v in agent.model.state_dict().items()}
    best = train_gdpg.main(argv, agent=agent)
    out = capsys.readouterr().out
    losses = [float(line.split("Loss: ")[1].split()[0])
              for line in out.splitlines() if "Loss: " in line]
    assert len(losses) >= 2 and np.all(np.isfinite(losses))
    assert any(not torch.equal(v, before[k])
               for k, v in agent.model.state_dict().items())
    assert agent.epsilon < 1.0
    folder = directory.find_model_folder(cfg, "dqn",
                                         str(tmp_path / "models"))
    if best > 0.55:
        assert os.path.isfile(os.path.join(folder, "params.npz"))
    written = {p.name for p in tmp_path.iterdir()}
    assert written <= {"train", "test", "models", "packs"}


def test_train_gdpg_resumes_and_seeds_the_gate_from_its_checkpoint(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DISTGCN_PACK_CACHE", str(tmp_path / "packs"))
    argv = _datasets(tmp_path) + ["--device_batch=5", "--epochs=6"]
    cfg = Config.from_args(argv)
    folder = directory.find_model_folder(cfg, "dqn",
                                         str(tmp_path / "models"))
    DQNAgent(cfg, device="cpu", seed=3).save(folder)
    train_gdpg.main(argv + ["--start_epoch=5", "--target_style=dqn"])
    out = capsys.readouterr().out
    assert f"loaded {folder}" in out and "checkpoint gate seeded" in out
    assert "Epsilon: 0.19" in out         # 0.2 reset state, then decay


def test_train_gdpg_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_gdpg.main(["--datapath=/nonexistent"])
