"""Device-side state construction (port of `distgcn_tpu/agents.py:53-87`).

Only the two state builders are ported in this slice; the agent classes
(`MWISSolver`, `DQNAgent`) come later.
"""

from __future__ import annotations

import torch

from distgcn_tpu_torch.core import prep


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
