"""Dense graph preprocessing: normalization and polynomial supports.

Port of the dense half of `distgcn_tpu/core/prep.py` (the reference's
`gcn/utils.py` semantics):

- ``normalize_adj_dense``: symmetric normalization D^-1/2 A D^-1/2, zero for
  isolated (or padding) nodes;
- ``simple_polynomials_dense``: supports [I, L, L^2, .., L^K] with
  L = I - normalize_adj(A), full identity (every diagonal entry is 1);
- ``masked_simple_polynomials_dense``: the same with padding rows/cols of
  the identity zeroed, so the padded computation restricted to real nodes
  equals the unpadded one;
- ``preprocess_features_dense``: row normalization, zero-sum rows -> 0.

Normalization math always runs in f32, on any [..., N, N] batch.

``normalize_adj`` is the host (scipy) normalization the large-graph
builder uses, float64 as in the reference.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def normalize_adj(adj) -> sp.coo_matrix:
    """Symmetric normalization D^-1/2 A D^-1/2 of a scipy adjacency
    (gcn/utils.py:120-128); rows of isolated nodes are zero."""
    adj = sp.coo_matrix(adj)
    rowsum = np.array(adj.sum(1)).flatten()
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(rowsum, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt)
    # (A @ D^-1/2)^T @ D^-1/2 == D^-1/2 A^T D^-1/2; A is symmetric
    return adj.dot(d).transpose().dot(d).tocoo()


def normalize_adj_dense(adj: torch.Tensor) -> torch.Tensor:
    """Symmetric normalization of a dense [..., N, N] adjacency (int8
    structure or float)."""
    adj = adj.to(torch.float32)
    deg = adj.sum(dim=-1)
    # 1/sqrt rather than rsqrt, as in the JAX package (its TPU rsqrt
    # approximation broke activation parity with the reference)
    d_inv_sqrt = torch.where(deg > 0,
                             1.0 / torch.sqrt(torch.clamp(deg, min=1e-30)),
                             torch.zeros_like(deg))
    return adj * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]


def simple_polynomials_dense(adj: torch.Tensor, k: int) -> torch.Tensor:
    """Stack [I, L, L^2, ..., L^k] -> [..., k+1, N, N]."""
    adj = adj.to(torch.float32)
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device).expand(adj.shape)
    lap = eye - normalize_adj_dense(adj)
    mats = [eye, lap]
    for _ in range(2, k + 1):
        mats.append(torch.matmul(mats[-1], lap))
    return torch.stack(mats[: k + 1], dim=-3)


def masked_simple_polynomials_dense(adj: torch.Tensor, mask: torch.Tensor,
                                    k: int) -> torch.Tensor:
    """Like :func:`simple_polynomials_dense`, identity zeroed on padding."""
    adj = adj.to(torch.float32)
    n = adj.shape[-1]
    m = mask.to(adj.dtype)
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device) * m[..., None, :]
    eye = eye.expand(adj.shape) * m[..., :, None]
    lap = eye - normalize_adj_dense(adj)
    mats = [eye, lap]
    for _ in range(2, k + 1):
        mats.append(torch.matmul(mats[-1], lap))
    return torch.stack(mats[: k + 1], dim=-3)


def preprocess_features_dense(features: torch.Tensor) -> torch.Tensor:
    """Row-normalize [..., N, F] with zero-sum rows -> 0."""
    rowsum = features.sum(dim=-1, keepdim=True)
    safe = torch.where(rowsum == 0, torch.ones_like(rowsum), rowsum)
    inv = torch.where(rowsum != 0, 1.0 / safe, torch.zeros_like(rowsum))
    return features * inv
