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

The host (scipy/numpy) half, float64 as in the reference, for host-side
parity, dataset tools and the large-graph builder (`normalize_adj`):

- ``normalize_adj``: D^-1/2 A D^-1/2 (gcn/utils.py:120-128);
- ``preprocess_adj``: normalize_adj(A + I) (gcn/utils.py:130-135);
- ``laplacian_support``: L = I - normalize_adj(A);
- ``simple_polynomials``: [I, L, .., L^K], no self loops (gcn/utils.py:
  258-274), the support set every agent uses;
- ``chebyshev_polynomials``: the scaled-Laplacian Chebyshev recurrence
  (gcn/utils.py:235-255);
- ``plain_polynomials``: [I, I - A, (I - A)^2, ..], unnormalized
  (gcn/utils.py:325-340);
- ``preprocess_features``: row normalization, zero-sum rows -> 0
  (gcn/utils.py:98-106);
- ``sparse_to_tuple``: the reference's COO feed format (gcn/utils.py:79-95).
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


def preprocess_adj(adj) -> sp.coo_matrix:
    """normalize_adj(A + I) (gcn/utils.py:130-135)."""
    return normalize_adj(adj + sp.eye(adj.shape[0]))


def laplacian_support(adj) -> sp.csr_matrix:
    """L = I - normalize_adj(A)."""
    return (sp.eye(adj.shape[0]) - normalize_adj(adj)).tocsr()


def simple_polynomials(adj, k: int) -> list:
    """[I, L, L^2, ..., L^k] with L = I - normalize_adj(A)
    (gcn/utils.py:258-274)."""
    lap = laplacian_support(adj)
    t_k = [sp.eye(adj.shape[0]).tocsr(), lap]
    for _ in range(2, k + 1):
        t_k.append(t_k[-1] @ lap)
    return t_k[: k + 1]


def chebyshev_polynomials(adj, k: int) -> list:
    """Chebyshev recurrence on the scaled Laplacian 2 L / lambda_max - I
    (gcn/utils.py:235-255); lambda_max from ARPACK (`scipy.sparse.linalg.
    eigs`, the largest real part)."""
    from scipy.sparse.linalg import eigs

    lap = laplacian_support(adj)
    largest_eigval, _ = eigs(lap, 1, which="LR", maxiter=5000)
    scaled_lap = (2.0 / largest_eigval[0].real) * lap - sp.eye(adj.shape[0])
    t_k = [sp.eye(adj.shape[0]).tocsr(), scaled_lap.tocsr()]
    for _ in range(2, k + 1):
        t_k.append(2.0 * (scaled_lap @ t_k[-1]) - t_k[-2])
    return t_k[: k + 1]


def plain_polynomials(adj, k: int) -> list:
    """[I, I - A, (I - A)^2, ...], unnormalized (gcn/utils.py:325-340)."""
    lap = (sp.eye(adj.shape[0]) - adj).tocsr()
    t_k = [sp.eye(adj.shape[0]).tocsr(), lap]
    for _ in range(2, k + 1):
        t_k.append(t_k[-1] @ lap)
    return t_k[: k + 1]


def preprocess_features(features) -> np.ndarray:
    """Row-normalize a host [N, F] array in float64; rows summing to 0
    stay 0 (gcn/utils.py:98-106). Returns float32."""
    features = np.asarray(features, dtype=np.float64)
    rowsum = features.sum(axis=1)
    with np.errstate(divide="ignore"):
        r_inv = np.power(rowsum, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    return (features * r_inv[:, None]).astype(np.float32)


def sparse_to_tuple(mx):
    """COO tuple (coords [nnz, 2], values, shape): the reference's feed
    format (gcn/utils.py:79-95), kept for dataset and interop tools."""
    mx = sp.coo_matrix(mx)
    coords = np.vstack((mx.row, mx.col)).transpose()
    return coords, mx.data, mx.shape


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
