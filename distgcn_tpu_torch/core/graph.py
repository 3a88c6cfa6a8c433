"""Graph containers: fixed-shape dense padded batches on the device.

Port of `distgcn_tpu/core/graph.py`. Conflict graphs are small (N ~ 1e2..1e3),
so a dense [B, N, N] adjacency turns every support application into a
batched matmul and each LGS round into a masked reduction.

`GraphBatch` fields (all tensors on one device):
    adj  : [B, N, N] int8   symmetric 0/1, zero diagonal, zero padding
    wts  : [B, N]    float  node weights (padding = 0)
    mask : [B, N]    bool   True for real nodes
    nn   : [B]       int32  number of real nodes per graph
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import scipy.sparse as sp
import torch

from distgcn_tpu_torch.utils.device import resolve_device


def pad_bucket(n: int, bucket: int = 128) -> int:
    """Round n up to a multiple of `bucket`."""
    return int(max(bucket, -(-n // bucket) * bucket))


def graph_fingerprint(adj) -> tuple:
    """Cheap O(nnz) content key for caching device graph batches across
    timeslots (the same conflict graph arrives as new scipy objects)."""
    a = adj if sp.issparse(adj) else sp.csr_matrix(np.asarray(adj))
    a = a.tocsr()
    return (a.shape[0], int(a.nnz), hash(a.indptr.tobytes()),
            hash(a.indices.tobytes()))


def _dense_from_edges(edges: torch.Tensor, n: int) -> torch.Tensor:
    """Densify a padded upper-triangular edge list [B, E, 2] on its device.

    Padding rows are (0, 0): they land on the diagonal, which is zeroed
    afterwards (conflict graphs have no self-loops). The adjacency persists
    as int8 0/1; numeric consumers cast at their boundary.
    """
    b, e, _ = edges.shape
    b_idx = torch.arange(b, device=edges.device)[:, None].expand(b, e)
    adj = torch.zeros((b, n, n), dtype=torch.int8, device=edges.device)
    adj[b_idx, edges[..., 0], edges[..., 1]] = 1
    adj = torch.maximum(adj, adj.transpose(-1, -2))
    adj.diagonal(dim1=-2, dim2=-1).zero_()
    return adj


class GraphBatch:
    """A fixed-shape batch of padded graphs."""

    def __init__(self, adj, wts, mask, nn):
        self.adj = adj
        self.wts = wts
        self.mask = mask
        self.nn = nn

    @property
    def batch_size(self) -> int:
        return self.adj.shape[0]

    @property
    def pad_n(self) -> int:
        return self.adj.shape[-1]

    def __repr__(self):
        return f"GraphBatch(B={self.batch_size}, N={self.pad_n})"

    @classmethod
    def from_scipy(cls, adjs: Sequence[Union[sp.spmatrix, np.ndarray]],
                   wts: Sequence[np.ndarray], pad_to: int = 0,
                   bucket: int = 128, dtype=np.float32,
                   device=None) -> "GraphBatch":
        """Build a batch from per-graph scipy/np adjacencies + weights.

        The adjacency goes to the device as a padded upper-triangular edge
        list and is densified there.
        """
        dev = resolve_device(device)
        if not isinstance(adjs, (list, tuple)):
            adjs = [adjs]
            wts = [wts]
        sizes = [a.shape[0] for a in adjs]
        n = pad_to or pad_bucket(max(sizes), bucket)
        if n < max(sizes):
            raise ValueError(f"pad_to={n} < largest graph {max(sizes)}")
        b = len(adjs)
        w = np.zeros((b, n), dtype=dtype)
        mask = np.zeros((b, n), dtype=bool)
        edge_lists = []
        for i, (a, wt) in enumerate(zip(adjs, wts)):
            ni = a.shape[0]
            if sp.issparse(a):
                coo = a.tocoo()
                keep = coo.row < coo.col
                ei, ej = coo.row[keep], coo.col[keep]
            else:
                ei, ej = np.nonzero(np.triu(np.asarray(a), k=1))
            edge_lists.append((ei, ej))
            w[i, :ni] = np.asarray(wt, dtype=dtype).flatten()[:ni]
            mask[i, :ni] = True
        e_max = max(max(ei.size for ei, _ in edge_lists), 1)
        edges = np.zeros((b, e_max, 2), dtype=np.int64)
        for i, (ei, ej) in enumerate(edge_lists):
            edges[i, : ei.size, 0] = ei
            edges[i, : ei.size, 1] = ej
        adj = _dense_from_edges(torch.from_numpy(edges).to(dev), n)
        return cls(adj, torch.from_numpy(w).to(dev),
                   torch.from_numpy(mask).to(dev),
                   torch.tensor(sizes, dtype=torch.int32, device=dev))

    @classmethod
    def single(cls, adj, wts, pad_to: int = 0, bucket: int = 128,
               dtype=np.float32, device=None) -> "GraphBatch":
        return cls.from_scipy([adj], [wts], pad_to=pad_to, bucket=bucket,
                              dtype=dtype, device=device)

    def to_scipy(self) -> List[sp.csr_matrix]:
        adj = self.adj.cpu().numpy()
        nn = self.nn.cpu().numpy()
        return [sp.csr_matrix(adj[i, : nn[i], : nn[i]])
                for i in range(self.batch_size)]


def block_diag_stack(adjs: Sequence[Union[sp.spmatrix, np.ndarray]]
                     ) -> sp.csr_matrix:
    """Block-diagonal stack of adjacencies (the reference's `dstack`,
    gcn/utils.py:315-322, for k graphs)."""
    return sp.block_diag([sp.csr_matrix(a) for a in adjs]).tocsr()


def edges_from_dense(adj) -> tuple:
    """Upper-triangular edge list (i, j) arrays of a dense adjacency."""
    iu, ju = np.nonzero(np.triu(np.asarray(adj), k=1))
    return iu, ju
