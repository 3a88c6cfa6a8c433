"""The ChebGCN checkpoint as the reference reads it: the raw ``.npz``
file, ``gc<i>::w_0``, ``gc<i>::w_1`` and ``gc<i>::bias`` per layer."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch


def load_layers(path: Path, device) -> List[Dict[str, torch.Tensor]]:
    """Per-layer dicts {'w_0', 'w_1'[, 'bias']} of float32 tensors on
    `device`, in layer order gc1..gcL."""
    with np.load(path) as data:
        flat = {k: np.asarray(data[k], dtype=np.float32) for k in data.files}
    layers = []
    i = 1
    while f"gc{i}::w_0" in flat:
        layers.append({name: torch.from_numpy(flat[f"gc{i}::{name}"].copy())
                       .to(device) for name in ("w_0", "w_1", "bias")
                       if f"gc{i}::{name}" in flat})
        i += 1
    if not layers:
        raise ValueError(f"{path}: no gc1::w_0 entry")
    return layers
