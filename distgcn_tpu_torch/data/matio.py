""".mat dataset IO — the data contract of the reference `data/` directories.

The port's own copy of `distgcn_tpu/data/matio.py`.

Contract (Data_Generation.py:218-219, verified on data/*_GEN21_test2):
    adj            sparse CSC float (N, N)     conflict graph, 0/1 symmetric
    weights        (1, N) float                node weights
    N, p           scalars                     graph config
    mwis_label     (1, N) float 0/1            best-heuristic IS indicator
    mwis_utility   (1, 1) float                utility of that IS
    greedy_utility (1, 1) float                centralized-greedy utility

Filename schema ``{type}_n{N}_p{p}_b{i}_{dist}.mat`` parsed by
`test_utils.extract_N/extract_Np` (test_utils.py:51-60).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import scipy.io as sio
import scipy.sparse as sp


@dataclass
class GraphInstance:
    adj: sp.csr_matrix
    weights: np.ndarray            # (N,)
    name: str = ""
    mwis_label: Optional[np.ndarray] = None
    mwis_utility: Optional[float] = None
    greedy_utility: Optional[float] = None
    n: Optional[int] = None
    p: Optional[float] = None

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]


def load_mat(path: str) -> GraphInstance:
    m = sio.loadmat(path)
    adj = m["adj"]
    if not sp.issparse(adj):
        adj = sp.csr_matrix(adj)
    inst = GraphInstance(
        adj=adj.tocsr(),
        weights=np.asarray(m["weights"]).flatten().astype(np.float64),
        name=os.path.basename(path),
    )
    if "mwis_label" in m:
        inst.mwis_label = np.asarray(m["mwis_label"]).flatten()
    for key, attr in (("mwis_utility", "mwis_utility"),
                      ("greedy_utility", "greedy_utility")):
        if key in m:
            setattr(inst, attr, float(np.asarray(m[key]).flatten()[0]))
    for key, attr in (("N", "n"), ("p", "p")):
        if key in m:
            setattr(inst, attr, np.asarray(m[key]).flatten()[0])
    return inst


def save_mat(path: str, adj, weights, **extra) -> None:
    payload = {"adj": sp.csc_matrix(adj).astype(float),
               "weights": np.asarray(weights, dtype=float).reshape(1, -1)}
    payload.update(extra)
    sio.savemat(path, payload)


def list_dataset(datapath: str) -> List[str]:
    """Sorted .mat files — matches reference driver iteration order
    (`mwis_gdpg_train.py:44`)."""
    return sorted(f for f in os.listdir(datapath) if f.endswith(".mat"))


def extract_n(filename: str) -> int:
    """test_utils.py:57-60."""
    return int(filename[:-4].split("_")[1][1:])


def extract_np(filename: str) -> float:
    """test_utils.py:51-54."""
    parts = filename[:-4].split("_")
    return round(float(parts[2][1:]) * float(parts[1][1:]), 0)


# ---------------------------------------------------------------------------
# Packed datasets: one .npz per directory instead of thousands of .mat files.
# Training preloads the reference train set (5970 .mat files, minutes of
# scipy.io parsing per run); the pack loads the same instances in ~1s. Packs
# are content-addressed by (path, file count, total size) and stored under
# ~/.cache/distgcn_packs, so read-only dataset mounts stay untouched.
# ---------------------------------------------------------------------------

def _pack_path(datapath: str, files: List[str]) -> str:
    import hashlib
    root = os.environ.get(
        "DISTGCN_PACK_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "distgcn_packs"))
    total = sum(os.path.getsize(os.path.join(datapath, f)) for f in files)
    key = hashlib.sha1(
        f"v3|{os.path.abspath(datapath)}|{len(files)}|{total}".encode()
    ).hexdigest()[:16]
    return os.path.join(root, f"{key}.npz")


def pack_dataset(datapath: str, pack_file: Optional[str] = None) -> str:
    """Pack every .mat in `datapath` into a single .npz (CSR concatenation)."""
    files = list_dataset(datapath)
    pack_file = pack_file or _pack_path(datapath, files)
    os.makedirs(os.path.dirname(pack_file), exist_ok=True)
    indptrs, indices, wts, labels = [], [], [], []
    offsets = np.zeros(len(files) + 1, dtype=np.int64)   # node offsets
    eoffsets = np.zeros(len(files) + 1, dtype=np.int64)  # nnz offsets
    gutil = np.full(len(files), np.nan)
    mutil = np.full(len(files), np.nan)
    have_labels = True
    for i, f in enumerate(files):
        inst = load_mat(os.path.join(datapath, f))
        a = inst.adj.tocsr()
        # store GLOBAL edge positions (local indptr + running nnz offset);
        # the loader subtracts edge_offsets[i] back off
        indptrs.append(a.indptr[1:].astype(np.int64) + eoffsets[i])
        indices.append(a.indices.astype(np.int32))
        wts.append(inst.weights.astype(np.float32))
        offsets[i + 1] = offsets[i] + a.shape[0]
        eoffsets[i + 1] = eoffsets[i] + a.nnz
        if inst.greedy_utility is not None:
            gutil[i] = inst.greedy_utility
        if inst.mwis_utility is not None:
            mutil[i] = inst.mwis_utility
        if inst.mwis_label is None:
            have_labels = False
        elif have_labels:
            labels.append(np.asarray(inst.mwis_label,
                                     np.float32).flatten())
    np.savez_compressed(
        pack_file,
        names=np.asarray(files),
        node_offsets=offsets, edge_offsets=eoffsets,
        indptr=np.concatenate(indptrs) if indptrs else np.zeros(0, np.int64),
        indices=np.concatenate(indices) if indices else np.zeros(0, np.int32),
        weights=np.concatenate(wts) if wts else np.zeros(0, np.float32),
        labels=(np.concatenate(labels) if have_labels and labels
                else np.zeros(0, np.float32)),
        greedy_utility=gutil, mwis_utility=mutil)
    return pack_file


def load_dataset_cached(datapath: str) -> List[GraphInstance]:
    """Load all instances of a dataset dir, via the pack cache when possible.

    Falls back to per-file `load_mat` on any pack mismatch. Adjacency data
    is all-ones (the reference's conflict graphs are 0/1), so only the CSR
    structure is stored.
    """
    files = list_dataset(datapath)
    pack_file = _pack_path(datapath, files)
    if not os.path.isfile(pack_file):
        try:
            pack_dataset(datapath, pack_file)
        except Exception:
            return [load_mat(os.path.join(datapath, f)) for f in files]
    z = np.load(pack_file, allow_pickle=False)
    names = [str(s) for s in z["names"]]
    if names != files:
        return [load_mat(os.path.join(datapath, f)) for f in files]
    no, eo = z["node_offsets"], z["edge_offsets"]
    indptr, indices, weights = z["indptr"], z["indices"], z["weights"]
    gutil, mutil = z["greedy_utility"], z["mwis_utility"]
    labels = z["labels"] if "labels" in z.files else np.zeros(0, np.float32)
    have_labels = labels.size == no[-1]
    out = []
    for i, name in enumerate(names):
        n = int(no[i + 1] - no[i])
        ip = np.empty(n + 1, dtype=np.int64)
        ip[0] = 0
        ip[1:] = indptr[no[i]: no[i + 1]] - eo[i]
        # index dtypes MUST match: scipy's sparsetools segfault on a CSR
        # whose indptr/indices dtypes differ (no validation on that path)
        ip32 = ip.astype(np.int32)
        idx = indices[eo[i]: eo[i + 1]].astype(np.int32, copy=True)
        if (ip32[-1] != len(idx) or (np.diff(ip32) < 0).any()
                or (len(idx) and idx.max() >= n)):
            # corrupt/stale pack — rebuild from the source files
            try:
                os.remove(pack_file)
            except OSError:
                pass
            return [load_mat(os.path.join(datapath, f)) for f in files]
        adj = sp.csr_matrix((np.ones(len(idx), np.float32), idx, ip32),
                            shape=(n, n))
        inst = GraphInstance(
            adj=adj, weights=weights[no[i]: no[i + 1]].astype(np.float64),
            name=name,
            mwis_label=(labels[no[i]: no[i + 1]].copy() if have_labels
                        else None),
            greedy_utility=None if np.isnan(gutil[i]) else float(gutil[i]),
            mwis_utility=None if np.isnan(mutil[i]) else float(mutil[i]))
        out.append(inst)
    return out
