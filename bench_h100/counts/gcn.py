"""Model FLOPs of the ChebGCN forward (K=1), counted on real links and
real directed edges: per layer 2 * 2 * n * Fin * Fout for the two
W-products and 2 * e * Fout for the support product. The count does not
depend on how the program computes the layer (a padded dense product
counts only its sparse work)."""

from __future__ import annotations

from typing import Sequence


def layer_flops(n: int, e: int, fin: int, fout: int) -> int:
    return 4 * n * fin * fout + 2 * e * fout


def widths(feature_size: int, hidden: int, num_layer: int,
           out_dim: int = 1) -> list:
    return [feature_size] + [hidden] * (num_layer - 1) + [out_dim]


def forward_flops(n: int, e: int, dims: Sequence[int]) -> int:
    return sum(layer_flops(n, e, dims[i], dims[i + 1])
               for i in range(len(dims) - 1))
