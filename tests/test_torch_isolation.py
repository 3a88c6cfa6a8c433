"""The port stands alone: it imports no JAX, nothing of `distgcn_tpu` and
no pandas (the machine with the card has none), and its entry points run
on the card unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distgcn_tpu_torch.agents import DQNAgent
from distgcn_tpu_torch.agents_extra import (DiverAgent, LegacyDQNAgent,
                                            MLPAgent)
from distgcn_tpu_torch.cli import train_gdpg
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.models.gcn import make_model_from_config
from distgcn_tpu_torch.pipeline import BatchedEvaluator
from distgcn_tpu_torch.rl.train import ReplayTrainer
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import distgcn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(distgcn_tpu_torch.__path__,
                                               "distgcn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = {"jax", "jaxlib", "flax", "optax", "distgcn_tpu", "pandas"}
print(json.dumps({"modules": names,
                  "banned": sorted(m for m in sys.modules
                                   if m.split(".")[0] in banned)}))
"""


def test_port_and_chip_smoke_import_no_jax_or_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    # every module of the slice was imported
    for mod in ("agents", "pipeline", "core.graph", "core.prep",
                "models.gcn", "models.layers", "ops.lgs", "ops.lgs_cuda",
                "ops._build", "sim.device_sim", "utils.config",
                "utils.device", "utils.serialization", "ops.spmm",
                "ops.spmm_cuda", "ops.nbr_max_cuda", "ops.cheb_fused",
                "ops.cheb_fused_cuda", "large", "parallel.distributed",
                "parallel.halo", "parallel.large_sharded", "parallel.mesh",
                "utils.directory", "data.matio", "data.generate",
                "solvers.greedy", "compat.tf1_ckpt", "rl.losses", "rl.train",
                "rl.checkpoint", "cli.train_gdpg", "solvers.iterative",
                "agents_extra", "cli.eval_graphs", "cli.train_dqn",
                "cli.train_diver", "solvers.exact", "solvers.relax",
                "data.wireless", "sim.wireless", "cli.wireless_sim",
                "cli.gen_data", "cli.benchmark_solver", "dryrun",
                "utils.profiling", "utils.compile_cache"):
        assert f"distgcn_tpu_torch.{mod}" in result["modules"]
    assert result["banned"] == []


_NATIVE_PROBE = """
import json, sys
from distgcn_tpu_torch.solvers import exact
from distgcn_tpu_torch.sim import wireless
path = exact.native_library()
exact.mwis_exact([[0, 1], [1, 0]], [1.0, 2.0], 1.0)
with open("/proc/self/maps") as f:
    maps = sorted({line.split()[-1] for line in f if "/" in line})
banned = {"jax", "jaxlib", "flax", "optax", "distgcn_tpu", "pandas"}
print(json.dumps({"path": path, "maps": maps,
                  "banned": sorted(m for m in sys.modules
                                   if m.split(".")[0] in banned)}))
"""


def test_exact_solver_loads_only_the_ports_own_library():
    """The port builds and maps its own copy of the native solver, never
    the JAX package's library or source."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NATIVE_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    jax_native = os.path.join(REPO, "distgcn_tpu", "native") + os.sep
    own = os.path.join(REPO, "build", "native") + os.sep
    assert os.path.realpath(result["path"]).startswith(own)
    assert result["path"] in result["maps"]
    assert not [m for m in result["maps"] if m.startswith(jax_native)]
    assert result["banned"] == []


def test_default_device_entry_points_raise_without_a_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphBatch.from_scipy([np.zeros((3, 3))], [np.ones(3)])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_model_from_config(Config(num_layer=2))
    agent = type("Agent", (), {"model": None, "flags": Config(),
                               "feature_mode": "gdpg"})()
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEvaluator(agent)


def test_trainer_entry_points_raise_without_a_card(rng):
    """The agent, the replay trainer and `train_gdpg.main` default to the
    card. The train pipeline and the online loop run where their inputs
    lie, and those inputs come from `GraphBatch.from_scipy` and
    `make_model_from_config`, which default to the card (checked above)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = Config(num_layer=2, hidden1=8, feature_size=1, diver_num=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        DQNAgent(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_gdpg.main(["--datapath=/nonexistent", "--device_batch=8"])
    cpu_agent = DQNAgent(cfg, device="cpu")
    adj = np.ones((3, 3)) - np.eye(3)
    entry = ({"adj": adj, "wts": np.ones(3, np.float32)},
             np.ones((3, 1), np.float32), [0], {}, 1.0)
    assert np.isfinite(cpu_agent.trainer.train_minibatch([entry]))
    agent = type("Agent", (), {"model": cpu_agent.model, "flags": cfg,
                               "device": None, "feature_mode": "gdpg"})()
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplayTrainer(agent).train_minibatch([entry])


@pytest.mark.parametrize("cls", [LegacyDQNAgent, MLPAgent, DiverAgent])
def test_extra_agents_default_to_the_card(cls):
    """The extra agent families take the card unless asked for the CPU,
    and so do the CLIs that build them."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = Config(num_layer=2, hidden1=8, feature_size=1, diver_num=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(cfg)
    agent = cls(cfg, device="cpu")
    assert agent.device == torch.device("cpu")
    assert next(agent.model.parameters()).device.type == "cpu"


def test_eval_and_train_clis_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from distgcn_tpu_torch.cli import eval_graphs, train_diver, train_dqn
    for main in (eval_graphs.main, train_dqn.main, train_diver.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--datapath=/nonexistent", "--test_datapath=/nonexistent",
                  "--model_root=/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_graphs.main(["--datapath=/nonexistent", "--rollout=1",
                          "--model_root=/nonexistent"])


@pytest.mark.parametrize("device_loop", [0, 1])
def test_wireless_cli_defaults_to_the_card(tmp_path, device_loop):
    """`wireless_sim` takes the card unless asked for the CPU, in the host
    engine and in the device loop, before it reads any network."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from distgcn_tpu_torch.cli import wireless_sim
    with pytest.raises(RuntimeError, match="CUDA"):
        wireless_sim.main([f"--test_datapath={tmp_path}", "--opt=7",
                           f"--device_loop={device_loop}",
                           f"--output={tmp_path}"])


def test_dryrun_defaults_to_the_card():
    """The flagship solve, the multi-card dry run and its command line
    take the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from distgcn_tpu_torch import dryrun
    for call in (dryrun.entry, lambda: dryrun.dryrun_multichip(1),
                 lambda: dryrun.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cpu_device_sets_full_f32_matmuls():
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
