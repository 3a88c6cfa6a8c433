"""Flat ``::``-keyed .npz parameter files (the JAX package's native format).

`load_params` reads one into nested dicts of numpy arrays — the parameter
tree layout of the JAX package (``{"gc1": {"w_0": ..., "bias": ...}}``) —
which `models.gcn.params_from_jax` turns into a PyTorch ``state_dict``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SEP = "::"


def load_params(path: str) -> Dict:
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split(SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree
