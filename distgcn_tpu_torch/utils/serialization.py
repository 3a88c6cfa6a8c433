"""Flat ``::``-keyed .npz parameter files (the JAX package's native format).

`load_params` reads one into nested dicts of numpy arrays — the parameter
tree layout of the JAX package (``{"gc1": {"w_0": ..., "bias": ...}}``) —
which `models.gcn.params_from_jax` turns into a PyTorch ``state_dict``;
`save_params` writes such a tree (`models.gcn.params_to_jax` makes one from
a ``state_dict``), and the JAX package's `load_params` reads the file.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SEP = "::"


def save_params(path: str, params) -> None:
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, (prefix + SEP + k) if prefix else k)
        else:
            flat[prefix] = np.asarray(tree)

    walk(params, "")
    np.savez(path, **flat)


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
