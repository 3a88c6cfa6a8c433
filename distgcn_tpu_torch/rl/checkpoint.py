"""Training-state checkpoints that either package can resume.

Port of `distgcn_tpu/rl/checkpoint.py`. The reference saves only model
variables (mwis_gdpg_call.py:109-118); here the full training state
round-trips: params, target params, optimizer state, epsilon, best test
ratio and step counters.

The files are the JAX package's: ``params.npz`` and ``target_params.npz``
(``::``-keyed), ``opt_state.npz`` and ``train_meta.json``. ``opt_state.npz``
holds the optimizer state's leaves as ``arr_0, arr_1, ...`` in the order
``jax.tree_util.tree_flatten`` gives the JAX ``{"count", "m", "v"}`` tree:
the int32 count, then the ``m`` leaves, then the ``v`` leaves, each in
sorted (layer, name) key order. So a directory written by either package
loads into the other's agent.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import List, Optional

import numpy as np
import torch

from distgcn_tpu_torch.models.gcn import params_from_jax, params_to_jax
from distgcn_tpu_torch.utils.serialization import load_params, save_params


def jax_leaf_order(names) -> List[str]:
    """State-dict names (``gc1.w_0``) in `jax.tree_util`'s leaf order of
    the matching nested dict: keys sorted at each level."""
    return sorted(names, key=lambda k: tuple(k.split(".")))


def save_training_state(path: str, agent, best_ratio: float = 0.0,
                        step: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    save_params(os.path.join(path, "params.npz"),
                params_to_jax(agent.model.state_dict()))
    if getattr(agent, "target_params", None) is not None:
        save_params(os.path.join(path, "target_params.npz"),
                    params_to_jax(agent.target_params))
    trainer = getattr(agent, "trainer", None)
    if trainer is not None:
        st = trainer.opt_state
        keys = jax_leaf_order(st["m"])
        flat = ([np.asarray(st["count"], dtype=np.int32)]
                + [st["m"][k].cpu().numpy() for k in keys]
                + [st["v"][k].cpu().numpy() for k in keys])
        np.savez(os.path.join(path, "opt_state.npz"), *flat)
    meta = {"epsilon": float(agent.epsilon), "best_ratio": float(best_ratio),
            "step": int(step),
            "update_cnt": int(getattr(agent, "update_cnt", 0))}
    with open(os.path.join(path, "train_meta.json"), "w") as f:
        json.dump(meta, f)


def load_training_state(path: str, agent) -> Optional[dict]:
    """Restores in place; returns the meta dict or None if absent."""
    pfile = os.path.join(path, "params.npz")
    if not os.path.isfile(pfile):
        return None
    agent.model.load_state_dict(params_from_jax(load_params(pfile)))
    tfile = os.path.join(path, "target_params.npz")
    if os.path.isfile(tfile) and hasattr(agent, "target_params"):
        agent.target_params = {k: v.to(agent.device) for k, v in
                               params_from_jax(load_params(tfile)).items()}
    ofile = os.path.join(path, "opt_state.npz")
    trainer = getattr(agent, "trainer", None)
    if trainer is not None and os.path.isfile(ofile):
        with np.load(ofile) as data:
            flat = [data[f"arr_{i}"] for i in range(len(data.files))]
        keys = jax_leaf_order(trainer.opt_state["m"])
        if len(flat) == 1 + 2 * len(keys):
            m = flat[1: 1 + len(keys)]
            v = flat[1 + len(keys):]
            trainer.opt_state = {
                "count": int(flat[0]),
                "m": {k: torch.from_numpy(x).to(agent.device)
                      for k, x in zip(keys, m)},
                "v": {k: torch.from_numpy(x).to(agent.device)
                      for k, x in zip(keys, v)}}
        else:
            # optimizer-structure change across versions: resume with
            # params but a fresh optimizer state instead of failing
            warnings.warn(
                f"opt_state.npz has {len(flat)} leaves but the current "
                f"optimizer expects {1 + 2 * len(keys)} — optimizer state "
                "NOT restored (params/epsilon are); Adam moments restart")
    mfile = os.path.join(path, "train_meta.json")
    meta = None
    if os.path.isfile(mfile):
        with open(mfile) as f:
            meta = json.load(f)
        agent.epsilon = meta.get("epsilon", agent.epsilon)
        if hasattr(agent, "update_cnt"):
            agent.update_cnt = meta.get("update_cnt", 0)
    return meta or {}
