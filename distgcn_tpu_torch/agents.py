"""Agent / solver API: state builders, `MWISSolver` and `DQNAgent`.

Port of `distgcn_tpu/agents.py` (the reference's `mwis_gdpg_call.py`
agent API). Inputs and outputs match the JAX package: scipy sparse
adjacency + (N,) or (N,1) weights in, python ``set`` of node ids + total
utility out. The model and its parameters live on the agent's `device`
(CUDA by default; `device="cpu"` runs the plain PyTorch paths); on a card
every solve's LGS is the hand-written kernel (`ops/lgs_cuda.py`).

Training semantics preserved (mwis_gdpg_call.py):
- makestate features (:82-97): predict='mwis' -> row-normalized ones
  (= 1/feature_size); else weight-scaled features.
- act (:696-705): epsilon only affects the returned `action` sample, NOT
  act_vals (the reference quirk — exploration in GDPG training comes from
  per-graph weight re-randomization, mwis_gdpg_train.py:94).
- memorize / replay (:707-769): target_f[solution] += reward; batch
  standardization target/std - mean + 1; memory cleared after replay;
  epsilon decay; target net sync every C=10 replays.

The replay minibatch is drawn from the agent's own `random.Random(seed)`
(the JAX package draws from the global `random` module). The iterative
solvers (DIT, CGS, rollout) are `solvers/iterative.py`'s.
"""

from __future__ import annotations

import dataclasses
import os
import random
from collections import deque
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.compat import tf1_ckpt
from distgcn_tpu_torch.core import prep
from distgcn_tpu_torch.core.graph import GraphBatch, pad_bucket
from distgcn_tpu_torch.models.gcn import (make_model_from_config,
                                          params_from_jax, params_to_jax)
from distgcn_tpu_torch.ops.lgs import batched_lgs
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.device import resolve_device
from distgcn_tpu_torch.utils.serialization import load_params, save_params


def build_state_arrays(adj: torch.Tensor, wts: torch.Tensor,
                       mask: torch.Tensor, feature_size: int, max_degree: int,
                       predict: str = "mwis", feature_mode: str = "gdpg"):
    """Device-side `makestate` (mwis_gdpg_call.py:82-97).

    Returns (features [B,N,F], supports [B,S,N,N]); the supports are the
    UNMASKED `simple_polynomials_dense`, as in the JAX package.
    """
    supports = prep.simple_polynomials_dense(adj, max_degree)
    return build_features(wts, mask, feature_size, predict,
                          feature_mode), supports


def build_features(wts: torch.Tensor, mask: torch.Tensor, feature_size: int,
                   predict: str = "mwis", feature_mode: str = "gdpg"):
    """The weight-dependent half of `build_state_arrays`.

    predict='mwis': 1/F on every real node (feature_mode='gdpg'), or only
    where w != 0 (feature_mode='dqn'). Otherwise w / max|w| broadcast
    across F.
    """
    b, n = wts.shape
    m = mask.to(wts.dtype)
    if predict == "mwis":
        base = torch.full((b, n, feature_size), 1.0 / feature_size,
                          dtype=wts.dtype, device=wts.device)
        if feature_mode == "dqn":
            nz = (wts != 0).to(wts.dtype)
            return base * (m * nz)[..., None]
        return base * m[..., None]
    norm = (wts.abs() * m).amax(dim=-1, keepdim=True) + 1e-9
    features = (wts / norm)[..., None].expand(b, n, feature_size)
    return features * m[..., None]


def _copy_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class MWISSolver:
    """Base agent: GCN scoring + LGS (mwis_gdpg_call.py:52-659)."""

    def __init__(self, flags: Config, memory_size: int = 5000,
                 model_family: str = "gcn2_dqn", seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.flags = flags
        self.feature_size = flags.feature_size
        self.memory: deque = deque(maxlen=memory_size)
        self.reward_mem: deque = deque(maxlen=memory_size)
        self.delta = 1e-6
        self.gamma = flags.gamma
        self.epsilon = flags.epsilon
        self.epsilon_min = flags.epsilon_min
        self.epsilon_decay = flags.epsilon_decay
        self.learning_rate = flags.learning_rate
        self.model_family = model_family
        self.model = make_model_from_config(
            flags, model_family, generator=torch.Generator().manual_seed(seed),
            device=self.device)
        self.feature_mode = "gdpg"
        self._rng = np.random.default_rng(seed)
        self._replay_rng = random.Random(seed)
        self._seed = seed

    # ------------------------------------------------------------------ io
    def load(self, name: str) -> bool:
        """Load params: native .npz if present, else TF1 checkpoint import
        (mwis_gdpg_call.py:109-114 directory protocol)."""
        npz = os.path.join(name, "params.npz")
        if os.path.isfile(npz):
            tree = load_params(npz)
            print(f"loaded {npz}")
            self._reconcile_arch(tree)
            return True
        try:
            scope = "gcn_dqn" if self.model_family == "gcn_dqn" else "gcn2_dqn"
            raw = tf1_ckpt.load_tf1_gcn_params(name, scope=scope)
        except (FileNotFoundError, ValueError, ImportError):
            return False
        print(f"loaded TF1 checkpoint from {name}")
        # outside the try: a reconcile failure must surface, not be
        # swallowed into "load failed"
        self._reconcile_arch(raw)
        return True

    def _reconcile_arch(self, tree) -> None:
        """Load a parameter tree, first rebuilding the model (and the flags
        that drive feature/support construction) when the tree's shapes or
        bias structure disagree with the configured ones. A few reference
        zoo dirs hold differently-shaped weights than their names claim;
        the importer trusts shapes, not names."""
        state = params_from_jax(tree)
        try:
            arch = tf1_ckpt.infer_architecture(tree)
        except (ValueError, KeyError, IndexError):
            # non-ChebGCN layouts (skip heads): keep the model as it is
            self.model.load_state_dict(state)
            return
        cfg = self.flags
        # bias is part of the checkpoint's structure, not its dims
        bias_differs = bool(self.model.use_bias) != arch["use_bias"]
        if bias_differs:
            print(f"checkpoint bias structure overrides model: "
                  f"use_bias={arch['use_bias']}")
        if self.model_family == "gcn2_dqn":
            out_flag, diver = 1, cfg.diver_num
        elif self.model_family == "deep_diver":
            out_flag = 2 * cfg.diver_num
            diver = max(arch["out_dim"] // 2, 1)
        else:
            out_flag, diver = cfg.diver_num, arch["out_dim"]
        dims_match = (arch["feature_size"] == cfg.feature_size
                      # 1-layer ckpts don't pin the hidden dim
                      and (arch["num_layer"] == 1
                           or arch["hidden_dim"] == cfg.hidden1)
                      and arch["num_layer"] == cfg.num_layer
                      and arch["num_supports"] == cfg.num_supports
                      and arch["out_dim"] == out_flag)
        if dims_match and not bias_differs:
            self.model.load_state_dict(state)
            return
        if not dims_match:
            hidden = (arch["hidden_dim"] if arch["num_layer"] > 1
                      else cfg.hidden1)
            self.flags = dataclasses.replace(
                cfg, feature_size=arch["feature_size"], hidden1=hidden,
                num_layer=arch["num_layer"],
                max_degree=arch["num_supports"] - 1, diver_num=diver)
            self.feature_size = self.flags.feature_size
            print(f"checkpoint shapes override config: feature_size="
                  f"{self.flags.feature_size} num_layer="
                  f"{self.flags.num_layer} supports={arch['num_supports']} "
                  f"out_dim={arch['out_dim']}")
        self.model = make_model_from_config(self.flags, self.model_family,
                                            params=state, device=self.device)
        self.__dict__.pop("_resident_pipe", None)
        # refresh state that was shaped by the pre-load architecture
        if hasattr(self, "target_params"):
            self.target_params = _copy_state(self.model)
        if hasattr(self, "trainer"):
            from distgcn_tpu_torch.rl.train import ReplayTrainer
            self.trainer = ReplayTrainer(self, style=self.trainer.style)

    def save(self, name: str) -> None:
        os.makedirs(name, exist_ok=True)
        save_params(os.path.join(name, "params.npz"),
                    params_to_jax(self.model.state_dict()))

    # --------------------------------------------------------------- state
    def makestate(self, adj, wts_nn) -> dict:
        """Host-facing state dict: the padded single-graph batch and its
        features and supports on the device, plus the host adjacency and
        float32 weights that `memorize` keeps."""
        gb = self._to_batch(adj, np.asarray(wts_nn))
        features, supports = build_state_arrays(
            gb.adj, gb.wts, gb.mask, self.flags.feature_size,
            self.flags.max_degree, self.flags.predict, self.feature_mode)
        return {"graph": gb, "features": features, "supports": supports,
                "wts": np.asarray(wts_nn, dtype=np.float32).flatten(),
                "adj": sp.csr_matrix(adj)}

    def _to_batch(self, adj, wts) -> GraphBatch:
        bucket = pad_bucket(adj.shape[0], self.flags.pad_to)
        return GraphBatch.single(adj, wts, pad_to=bucket, device=self.device)

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def predict(self, state) -> Tuple[np.ndarray, np.ndarray]:
        """act_values (N, out_dim) + argmax action (mwis_gdpg_call.py:
        690-694)."""
        gb: GraphBatch = state["graph"]
        out = self.model(state["features"], state["supports"])
        out = out * gb.mask[..., None].to(out.dtype)
        n = state["adj"].shape[0]
        act_values = out[0, :n, :].cpu().numpy()
        return act_values, np.argmax(act_values, axis=0)

    def act(self, state, train: bool):
        act_values, action = self.predict(state)
        if train and self._rng.random() <= self.epsilon:
            # reference quirk: epsilon replaces only `action`
            # (mwis_gdpg_call.py:696-705); act_values pass through.
            action = self._rng.random((act_values.size, 1))
        return act_values, action

    # ------------------------------------------------------------- solvers
    def _gcn_weights(self, act_vals: np.ndarray, wts_nn: np.ndarray
                     ) -> np.ndarray:
        """predict='mwis': w * gcn_out; else gcn_out
        (mwis_gdpg_call.py:211-217)."""
        if self.flags.predict == "mwis":
            return np.multiply(act_vals.flatten()[: wts_nn.size],
                               wts_nn.flatten())
        return act_vals.flatten()[: wts_nn.size]

    def solve_mwis(self, adj_0, wts_0, train: bool = False, grd: float = 1.0):
        """GCN + LGS, one shot (mwis_gdpg_call.py:200-235)."""
        wts_nn = np.reshape(np.asarray(wts_0, dtype=np.float64), (-1, 1))
        state = self.makestate(adj_0, wts_nn)
        act_vals, _ = self.act(state, train)
        gcn_wts = self._gcn_weights(act_vals, wts_nn)
        mwis, total_wt = self._lgs_host_or_device(state, gcn_wts, wts_nn)
        if train:
            reward = total_wt / (grd + 1e-6)
            if not np.isnan(reward):
                self.memorize(state, act_vals.copy(), list(mwis), {}, reward)
        return mwis, total_wt

    def schedule(self, adj_0, wts_0, train: bool = False):
        """GCN + LGS returning (mwis, util, state, act_vals)
        (mwis_gdpg_call.py:162-187)."""
        wts_nn = np.reshape(np.asarray(wts_0, dtype=np.float64), (-1, 1))
        state = self.makestate(adj_0, wts_nn)
        act_vals, _ = self.act(state, train)
        gcn_wts = self._gcn_weights(act_vals, wts_nn)
        mwis, total_wt = self._lgs_host_or_device(state, gcn_wts, wts_nn)
        return mwis, total_wt, state, act_vals

    def utility(self, adj_0, wts_0, train: bool = False):
        """GCN output only (mwis_gdpg_call.py:147-160)."""
        wts_nn = np.reshape(np.asarray(wts_0, dtype=np.float64),
                            (-1, self.flags.feature_size))
        state = self.makestate(adj_0, wts_nn[:, :1])
        act_vals, _ = self.act(state, train)
        return act_vals, state

    def topology_encode(self, adj_0, wts_0, train: bool = False):
        """mwis_gdpg_call.py:189-198."""
        wts_nn = np.reshape(np.asarray(wts_0), (-1, 1))
        state = self.makestate(adj_0, wts_nn)
        act_vals, _ = self.act(state, train)
        return act_vals

    def solve_mwis_util(self, adj_0, wts_0, wts_u, train: bool = False,
                        grd: float = 1.0):
        """Utility-weighted variant (mwis_gdpg_call.py:237-276)."""
        wts_nn = np.reshape(np.asarray(wts_0, dtype=np.float64), (-1, 1))
        state = self.makestate(adj_0, wts_nn)
        act_vals, _ = self.act(state, train)
        gcn_wts = self._gcn_weights(act_vals, wts_nn)
        mwis, _ = self._lgs_host_or_device(state, gcn_wts, wts_nn)
        wts_u = np.asarray(wts_u).flatten()
        total_wt = float(wts_u[list(mwis)].sum())
        if train:
            reward = total_wt / (grd + 1e-6)
            if not np.isnan(reward):
                self.memorize(state, act_vals.copy(), list(mwis), wts_u,
                              reward)
        return mwis, total_wt

    def _lgs_host_or_device(self, state, gcn_wts, wts_nn):
        """LGS on the device on the already-resident graph (one kernel
        launch on a card); returns the reference (set,
        util-under-original-weights)."""
        gb: GraphBatch = state["graph"]
        n = state["adj"].shape[0]
        padded = np.zeros((1, gb.pad_n), dtype=np.float32)
        padded[0, :n] = gcn_wts
        sel = batched_lgs(gb.adj, torch.from_numpy(padded).to(self.device),
                          gb.mask)[0]
        sel = sel[0, :n].cpu().numpy()
        mwis = set(np.nonzero(sel == 1)[0].tolist())
        total_wt = float(np.asarray(wts_nn).flatten()[list(mwis)].sum()) \
            if mwis else 0.0
        return mwis, total_wt

    # ------------------------------------------------- resident fast path
    def prepare(self, adj) -> dict:
        """Pin a conflict graph on the device for repeated scheduling with
        changing weights (graph static, utilities change every slot): the
        supports and the boolean adjacency are built here once. Returns an
        opaque handle."""
        from distgcn_tpu_torch.pipeline import make_resident_pipeline
        n = adj.shape[0]
        gb = self._to_batch(adj, np.zeros(n))
        supports = prep.simple_polynomials_dense(gb.adj,
                                                 self.flags.max_degree)
        if self.flags.compute_dtype == "bfloat16":
            supports = supports.to(torch.bfloat16)
        if not hasattr(self, "_resident_pipe"):
            self._resident_pipe = make_resident_pipeline(
                self.model, self.flags, self.feature_mode)
        return {"gb": gb, "n": n, "supports": supports, "adjb": gb.adj > 0}

    def solve_mwis_resident(self, handle: dict, wts) -> Tuple[set, float]:
        """GCN+LGS on a prepared graph: streams only the weight vector."""
        gb: GraphBatch = handle["gb"]
        n = handle["n"]
        w = np.zeros((1, gb.pad_n), dtype=np.float32)
        w[0, :n] = np.asarray(wts, dtype=np.float32).flatten()
        sel, util = self._resident_pipe(
            handle["supports"], handle["adjb"],
            torch.from_numpy(w).to(self.device), gb.mask)
        sel = sel[0, :n].cpu().numpy()
        return set(np.nonzero(sel == 1)[0].tolist()), float(util[0])

    # delegated iterative / rollout solvers (solvers/iterative.py)
    def solve_mwis_dit(self, adj_0, wts_0, train: bool = False,
                       grd: float = 1.0):
        from distgcn_tpu_torch.solvers.iterative import solve_dit
        return solve_dit(self, adj_0, wts_0)

    def solve_mwis_cit_wrap(self, adj_0, wts_0, train: bool = False,
                            grd: float = 1.0):
        from distgcn_tpu_torch.solvers.iterative import solve_cgs
        return solve_cgs(self, adj_0, wts_0)

    solve_mwis_cit = solve_mwis_cit_wrap

    def solve_mwis_rollout_wrap(self, adj_0, wts_0, train: bool = False,
                                grd: float = 1.0, b: int = 16):
        from distgcn_tpu_torch.solvers.iterative import solve_rollout
        return solve_rollout(self, adj_0, wts_0, b=b)

    # -------------------------------------------------------------- memory
    def memorize(self, state, act_vals, solu, next_state, reward) -> None:
        self.memory.append((self._compact_state(state), np.asarray(act_vals),
                            list(solu), next_state, float(reward)))
        self.reward_mem.append(float(reward))

    @staticmethod
    def _compact_state(state) -> dict:
        """Store only (sparse adj, wts): supports and features are rebuilt
        on the device at replay time (they are pure functions of these)."""
        return {"adj": state["adj"], "wts": state["wts"]}

    def mellowmax(self, q_vec, omega, beta=None):
        """mwis_gdpg_call.py:140-145."""
        q = np.asarray(q_vec, dtype=np.float64)
        c = q.max()
        return c + np.log(np.sum(np.exp(omega * (q - c))) / q.size) / omega


class DQNAgent(MWISSolver):
    """GDPG/DQN agent with a target network (mwis_gdpg_call.py:662-839).

    `target_params` is a ``state_dict`` copy of the model's tensors.
    """

    def __init__(self, flags: Config, memory_size: int = 5000,
                 model_family: str = "gcn2_dqn", seed: int = 0,
                 device=None):
        super().__init__(flags, memory_size, model_family, seed, device)
        self.target_params = _copy_state(self.model)
        self.update_cnt = 0
        self.C = 10
        from distgcn_tpu_torch.rl.train import ReplayTrainer
        self.trainer = ReplayTrainer(self)

    def update_target_model(self) -> None:
        """copy model -> target (mwis_gdpg_call.py:771-776)."""
        self.target_params = _copy_state(self.model)

    def replay(self, batch_size: int) -> Optional[float]:
        """GDPG replay (mwis_gdpg_call.py:707-769): target-net sync every C,
        reward-augmented targets, batch standardization, per-sample updates,
        memory clear, epsilon decay."""
        if len(self.memory) < batch_size:
            return None
        if self.update_cnt > self.C or self.update_cnt == 0:
            self.update_target_model()
            self.update_cnt = 0
        self.update_cnt += 1
        minibatch = self._replay_rng.sample(list(self.memory), batch_size)
        loss = self.trainer.train_minibatch(minibatch)
        self.memory.clear()
        if self.epsilon > self.epsilon_min:
            self.epsilon *= self.epsilon_decay
        return loss

    def solve_mwis_cgs_train(self, adj_0, wts_0, train: bool = False,
                             grd: float = 1.0):
        """Episodic centralized-greedy rollout with backtracked discounted
        rewards (mwis_gdpg_call.py:778-839)."""
        from distgcn_tpu_torch.solvers.iterative import solve_cgs_episodic
        return solve_cgs_episodic(self, adj_0, wts_0, train=train, grd=grd)
