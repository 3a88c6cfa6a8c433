"""Multi-support graph convolution and dense layers.

Port of `distgcn_tpu/models/layers.py` (the reference's `gcn/layers.py`):

- `GraphConvolution`: per support k, ``pre_k = X @ W_k``,
  ``out = act(sum_k S_k @ pre_k (+ bias))`` over a dense support stack
  [B, S, N, N]. Params ``w_{k}`` [fin, fout] and ``bias`` [fout], the JAX
  package's names, so parameter trees carry over key for key.
- `Dense`: ``y = act(X @ W (+ b))``.
- `maxpool_aggregate`: per-feature masked neighbour max-aggregation.

Initialization: 'random' = glorot uniform U(±sqrt(6/(fi+fo))), drawn from an
explicit `torch.Generator`; 'zeros'. Dropout is not ported: the JAX
package applies it only under ``deterministic=False``, which none of its
callers (the trainers included) passes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def glorot_uniform(shape, generator: Optional[torch.Generator] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """U(±sqrt(6/(fan_in+fan_out))) on the CPU."""
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return u * (2.0 * limit) - limit


def leaky_relu02(x: torch.Tensor) -> torch.Tensor:
    """TF default leaky_relu alpha=0.2."""
    return F.leaky_relu(x, negative_slope=0.2)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _init(shape, wts_init: str, generator) -> torch.Tensor:
    if wts_init == "random":
        return glorot_uniform(shape, generator)
    return torch.zeros(shape)


class GraphConvolution(nn.Module):
    """Multi-support (Chebyshev-style) graph convolution.

    Input  x:        [B, N, Fin]
           supports: [B, S, N, N]
    Output           [B, N, Fout]

    ``identity_first``: every support builder emits S_0 = I, so
    S_0 @ pre == pre exactly and that product is skipped.
    """

    def __init__(self, in_dim: int, out_dim: int, num_supports: int,
                 act: Callable = leaky_relu02, use_bias: bool = False,
                 wts_init: str = "random", identity_first: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_supports = num_supports
        self.act = act
        self.identity_first = identity_first
        for k in range(num_supports):
            self.register_parameter(
                f"w_{k}", nn.Parameter(_init((in_dim, out_dim), wts_init,
                                             generator)))
        self.bias = (nn.Parameter(torch.zeros(out_dim)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor, supports: torch.Tensor):
        out = None
        for k in range(self.num_supports):
            pre = torch.matmul(x, getattr(self, f"w_{k}"))
            if not (k == 0 and self.identity_first):
                pre = torch.matmul(supports[:, k], pre)
            out = pre if out is None else out + pre
        if self.bias is not None:
            out = out + self.bias
        return self.act(out)


class Dense(nn.Module):
    """Plain dense layer."""

    def __init__(self, in_dim: int, out_dim: int, act: Callable = F.relu,
                 use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        self.weights = nn.Parameter(glorot_uniform((in_dim, out_dim),
                                                   generator))
        self.bias = (nn.Parameter(torch.zeros(out_dim)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor):
        out = torch.matmul(x, self.weights)
        if self.bias is not None:
            out = out + self.bias
        return self.act(out)


def maxpool_aggregate(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-feature masked neighbour max-aggregation:
    ``out[..., v, f] = max_u x[..., v, u] * y[..., u, f]``
    over x [..., N, N] and y [..., N, F] (the reference's unused
    `maxpooling` op, without its final concat/reshape layout quirk, as in
    the JAX package)."""
    return (x[..., :, :, None] * y[..., None, :, :]).amax(dim=-2)
