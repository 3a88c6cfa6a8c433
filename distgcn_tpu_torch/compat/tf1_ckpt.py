"""TF1 checkpoint importer — reads the reference model zoo into a parameter
tree (nested dicts of numpy arrays, which `models.gcn.params_from_jax` turns
into a ChebGCN state_dict).

The port's own copy of `distgcn_tpu/compat/tf1_ckpt.py`.

Checkpoint variable contract (verified against /root/reference/model/*):
    {prefix}graphconvolution_{i}_vars/weights_{k}   i = 1..num_layer, k = 0..S-1
    {prefix}graphconvolution_{i}_vars/bias          (when bias=True)
plus Adam slots (`.../Adam`, `.../Adam_1`) and `beta{1,2}_power`, all ignored.
The prefix is 'gcn_dqn/' for the GCN_DQN family (Model base uses the
lowercased class name as variable scope); GDPG agents build twin models under
name scopes 'model'/'target' (mwis_gdpg_call.py:666-669).

Maps onto the ChebGCN param tree: params['gc{i}']['w_{k}'] / ['bias'].

Requires tensorflow only for reading (guarded import); everything else in the
framework runs without TF.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _reader(ckpt_path: str):
    try:
        from tensorflow.python.training import py_checkpoint_reader
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "tensorflow is required to read TF1 checkpoints") from e
    return py_checkpoint_reader.NewCheckpointReader(ckpt_path)


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """Resolve <dir>/checkpoint protocol like tf.train.get_checkpoint_state
    (mwis_gdpg_call.py:109-114)."""
    marker = os.path.join(model_dir, "checkpoint")
    if os.path.isfile(marker):
        with open(marker) as f:
            for line in f:
                if line.startswith("model_checkpoint_path"):
                    name = line.split(":", 1)[1].strip().strip('"')
                    if not os.path.isabs(name):
                        name = os.path.join(model_dir, os.path.basename(name))
                    return name
    cand = os.path.join(model_dir, "model.ckpt")
    if os.path.isfile(cand + ".index"):
        return cand
    return None


def load_tf1_gcn_params(model_dir_or_ckpt: str, scope: str = "gcn_dqn",
                        prefix: str = "") -> Dict:
    """Load GCN weights from a TF1 checkpoint directory or ckpt path.

    Returns a params tree {'gc1': {'w_0': ..., 'w_1': ..., ['bias']},
    ...} ready for `models.gcn.params_from_jax`.
    """
    ckpt = model_dir_or_ckpt
    if os.path.isdir(ckpt):
        resolved = latest_checkpoint(ckpt)
        if resolved is None:
            raise FileNotFoundError(f"no checkpoint found in {ckpt}")
        ckpt = resolved
    elif not os.path.isfile(ckpt + ".index") and not os.path.isfile(ckpt):
        raise FileNotFoundError(f"no checkpoint at {ckpt}")
    r = _reader(ckpt)
    shapes = r.get_variable_to_shape_map()
    full_prefix = (prefix + "/" if prefix else "") + (
        scope + "/" if scope else "")
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for name in shapes:
        if "Adam" in name or name.endswith("_power"):
            continue
        if not name.startswith(full_prefix):
            continue
        rest = name[len(full_prefix):]
        # graphconvolution_{i}_vars/{weights_{k}|bias}
        parts = rest.split("/")
        if len(parts) != 2 or not parts[0].startswith("graphconvolution_"):
            continue
        layer_idx = int(parts[0].split("_")[1])
        key = parts[1]
        layer = params.setdefault(f"gc{layer_idx}", {})
        tensor = np.asarray(r.get_tensor(name), dtype=np.float32)
        if key.startswith("weights_"):
            layer[f"w_{int(key.split('_')[1])}"] = tensor
        elif key == "bias":
            layer["bias"] = tensor
    if not params:
        raise ValueError(
            f"no GCN variables under scope '{full_prefix}' in {ckpt}; "
            f"available: {sorted(shapes)[:8]}")
    return params


def describe_checkpoint(model_dir_or_ckpt: str) -> Dict[str, tuple]:
    """Variable name -> shape map (Adam slots filtered)."""
    ckpt = model_dir_or_ckpt
    if os.path.isdir(ckpt):
        ckpt = latest_checkpoint(ckpt)
    r = _reader(ckpt)
    return {k: tuple(v) for k, v in r.get_variable_to_shape_map().items()
            if "Adam" not in k and not k.endswith("_power")}


def infer_architecture(params: Dict) -> Dict:
    """Infer (num_layer, hidden, out_dim, num_supports, feature_size, bias)
    from imported params — enough to instantiate the matching ChebGCN."""
    layers = sorted(params, key=lambda s: int(s[2:]))
    first, last = params[layers[0]], params[layers[-1]]
    num_supports = len([k for k in first if k.startswith("w_")])
    return dict(
        num_layer=len(layers),
        feature_size=first["w_0"].shape[0],
        hidden_dim=first["w_0"].shape[1],
        out_dim=last["w_0"].shape[1],
        num_supports=num_supports,
        use_bias=any("bias" in params[l] for l in layers),
    )
