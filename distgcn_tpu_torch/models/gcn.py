"""GCN Q-network models.

Port of `distgcn_tpu/models/gcn.py`. `ChebGCN` covers the reference's two
Q-net families, which share topology and differ in head activation/bias:

- gcn_dqn:  hidden layers leaky_relu(0.2), final layer linear, no bias;
- gcn2_dqn: the activation applies to every layer including the head, and
  every layer has a bias.

`MLP2` is the graph-blind dense Q-net (family mlp2) and `GCNDeepDiver` the
deep GCN with 2*diver_num logits read as diver_num two-class heads
(family deep_diver).

`params_from_jax` turns a JAX-package parameter tree (nested dicts of numpy
arrays, from Flax ``init`` or a ``model/*/params.npz``) into this module's
``state_dict`` and `params_to_jax` turns one back: the layer names
(``gc{i}``, ``dense{i}``, ``skip``) and parameter names (``w_{k}``,
``weights``, ``bias``, ``kernel``) are the JAX package's own.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from distgcn_tpu_torch.models.layers import (Dense, GraphConvolution,
                                             glorot_uniform, identity,
                                             leaky_relu02)
from distgcn_tpu_torch.utils.device import resolve_device


def skip_zeros_kernel(shape) -> torch.Tensor:
    """The reference's engineered zeros-init skip kernel: all zeros except
    rows 0..W/2-1, where row j writes -1 to column 2j and +1 to column
    2j+1 (W = output width; odd W degenerates as in the reference)."""
    fi, fo = shape
    w = np.zeros(shape, np.float32)
    for j in range(fo // 2):
        w[j, 2 * j] = -1.0
        w[j, 2 * j + 1] = 1.0
    return torch.from_numpy(w)


class SkipHead(nn.Module):
    """Concat-skip output head: ``dense(concat([features, gcn_out], -1))``,
    kernel glorot ('random') or `skip_zeros_kernel` ('zeros'), zero bias."""

    def __init__(self, feat_dim: int, out_dim: int, wts_init: str = "random",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (feat_dim + out_dim, out_dim)
        kernel = (glorot_uniform(shape, generator) if wts_init == "random"
                  else skip_zeros_kernel(shape))
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, features, gcn_out):
        sh = torch.cat([features, gcn_out], dim=-1)
        return torch.matmul(sh, self.kernel) + self.bias


def dueling_head(out: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Dueling combine: value = node-mean of column 0, advantage = the other
    columns centred per column; node means are masked on padded batches."""
    if mask is None:
        v = out[..., 0:1].mean(dim=-2, keepdim=True)
        a = out[..., 1:]
        return v + (a - a.mean(dim=-2, keepdim=True))
    m = mask.to(out.dtype)[..., None]
    cnt = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
    v = (out[..., 0:1] * m).sum(dim=-2, keepdim=True) / cnt
    a = out[..., 1:]
    return (v + (a - (a * m).sum(dim=-2, keepdim=True) / cnt)) * m


class ChebGCN(nn.Module):
    """Chebyshev-style GCN Q-network over batched dense supports.

    forward(x [B, N, F], supports [B, S, N, N], mask [B, N] | None)
    -> [B, N, out_dim].
    """

    def __init__(self, in_dim: int, num_layer: int = 1, hidden_dim: int = 32,
                 out_dim: int = 1, num_supports: int = 2,
                 hidden_act: Callable = leaky_relu02,
                 final_act_same: bool = False, use_bias: bool = False,
                 wts_init: str = "random", identity_first: bool = True,
                 skip: bool = False, is_dual: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layer = num_layer
        self.use_bias = use_bias
        self.use_skip = skip
        self.is_dual = is_dual
        final_act = hidden_act if final_act_same else identity
        # the dueling head emits out_dim+1 columns so the dueled output
        # keeps width out_dim
        head_dim = out_dim + 1 if is_dual else out_dim
        dims = [in_dim] + [hidden_dim] * (num_layer - 1) + [head_dim]
        for i in range(num_layer):
            last = i == num_layer - 1
            self.add_module(f"gc{i + 1}", GraphConvolution(
                dims[i], dims[i + 1], num_supports,
                act=final_act if last else hidden_act, use_bias=use_bias,
                wts_init=wts_init, identity_first=identity_first,
                generator=generator))
        if skip:
            self.add_module("skip", SkipHead(in_dim, head_dim, wts_init,
                                             generator))

    def forward(self, x, supports, mask=None):
        out = x
        for i in range(self.num_layer):
            out = getattr(self, f"gc{i + 1}")(out, supports)
        if self.use_skip:
            out = self.get_submodule("skip")(x, out)
        if self.is_dual:
            out = dueling_head(out, mask)
        if mask is not None:
            out = out * mask[..., None]
        return out


class MLP2(nn.Module):
    """n-layer dense Q-net (gcn/models.py:167-298), graph-blind: layers
    ``dense1..denseL`` with bias, leaky_relu(0.2) on the hidden layers, an
    identity head and an optional dueling combine (unmasked node means, as
    in the JAX package). forward(x [B, N, F]) -> [B, N, out_dim]."""

    def __init__(self, in_dim: int, num_layer: int = 2, hidden_dim: int = 32,
                 out_dim: int = 1, act: Callable = leaky_relu02,
                 is_dual: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layer = num_layer
        self.is_dual = is_dual
        width = out_dim + 1 if is_dual else out_dim
        dims = [in_dim] + [hidden_dim] * (num_layer - 1) + [width]
        for i in range(num_layer):
            last = i == num_layer - 1
            self.add_module(f"dense{i + 1}", Dense(
                dims[i], dims[i + 1], act=identity if last else act,
                use_bias=True, generator=generator))

    def forward(self, x):
        h = x
        for i in range(self.num_layer):
            h = getattr(self, f"dense{i + 1}")(h)
        if self.is_dual:
            return dueling_head(h)
        return h


class GCNDeepDiver(nn.Module):
    """GCN_DEEP_DIVER (gcn/models.py:301-438): ReLU ChebGCN layers
    ``gc1..gcL`` with no bias, a linear head of width 2*diver_num (diver_num
    two-class heads at interleaved column pairs), an optional `SkipHead`,
    and the output masked.

    forward(x [B, N, F], supports [B, S, N, N], mask [B, N] | None)
    -> [B, N, 2 * diver_num].
    """

    use_bias = False

    def __init__(self, in_dim: int, num_layer: int = 20, hidden_dim: int = 32,
                 diver_num: int = 32, num_supports: int = 2,
                 skip: bool = False, wts_init: str = "random",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layer = num_layer
        self.use_skip = skip
        dims = [in_dim] + [hidden_dim] * (num_layer - 1) + [2 * diver_num]
        for i in range(num_layer):
            last = i == num_layer - 1
            self.add_module(f"gc{i + 1}", GraphConvolution(
                dims[i], dims[i + 1], num_supports,
                act=identity if last else torch.relu, generator=generator))
        if skip:
            self.add_module("skip", SkipHead(in_dim, 2 * diver_num, wts_init,
                                             generator))

    def forward(self, x, supports, mask=None):
        out = x
        for i in range(self.num_layer):
            out = getattr(self, f"gc{i + 1}")(out, supports)
        if self.use_skip:
            out = self.get_submodule("skip")(x, out)
        if mask is not None:
            out = out * mask[..., None]
        return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) -> the port model's
    state_dict (any family: the layer and parameter names are JAX's)."""
    state = {}
    for layer, leaves in tree.items():
        for name, value in leaves.items():
            state[f"{layer}.{name}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """ChebGCN state_dict -> JAX parameter tree (nested dicts of numpy
    arrays): the inverse of `params_from_jax`."""
    tree: Dict[str, Dict] = {}
    for key, value in state.items():
        layer, name = key.split(".")
        tree.setdefault(layer, {})[name] = value.detach().cpu().numpy()
    return tree


def _has_bias(state: Mapping[str, torch.Tensor]) -> bool:
    # bias is part of a checkpoint's structure, as the JAX package's
    # `agents._reconcile_arch` decides it: any GCN layer with a bias
    return any(k.startswith("gc") and k.endswith(".bias") for k in state)


def make_model_from_config(cfg, family: str = "gcn_dqn",
                           is_dual: bool = False,
                           params: Optional[Mapping] = None,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> nn.Module:
    """Build the model matching a reference config, on `device`.

    family: 'gcn_dqn' (linear head, no bias), 'gcn2_dqn' (act on head,
    bias on every layer), 'mlp2' (`MLP2`) or 'deep_diver'
    (`GCNDeepDiver`). `cfg.skip` drives the concat-skip head on gcn_dqn
    and deep_diver; `is_dual` the dueling combine on gcn2_dqn and mlp2.

    params: an optional ``state_dict`` (see `params_from_jax`). On the
    ChebGCN families its bias structure overrides the family's; then it
    is loaded. Without it the weights are drawn from `generator` (default:
    seeded with `cfg.seed`).
    """
    dev = resolve_device(device)
    if family not in ("gcn_dqn", "gcn2_dqn", "mlp2", "deep_diver"):
        raise ValueError(f"unknown model family {family}")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    if family == "mlp2":
        model = MLP2(in_dim=cfg.feature_size, num_layer=cfg.num_layer,
                     hidden_dim=cfg.hidden1, out_dim=cfg.diver_num,
                     is_dual=is_dual, generator=generator)
    elif family == "deep_diver":
        model = GCNDeepDiver(in_dim=cfg.feature_size,
                             num_layer=cfg.num_layer, hidden_dim=cfg.hidden1,
                             diver_num=cfg.diver_num,
                             num_supports=cfg.num_supports, skip=cfg.skip,
                             wts_init=cfg.wts_init, generator=generator)
    else:
        gcn2 = family == "gcn2_dqn"
        use_bias = gcn2 if params is None else _has_bias(params)
        model = ChebGCN(in_dim=cfg.feature_size, num_layer=cfg.num_layer,
                        hidden_dim=cfg.hidden1,
                        out_dim=1 if gcn2 else cfg.diver_num,
                        num_supports=cfg.num_supports, final_act_same=gcn2,
                        use_bias=use_bias, wts_init=cfg.wts_init,
                        skip=cfg.skip and not gcn2, is_dual=is_dual and gcn2,
                        generator=generator)
    if params is not None:
        model.load_state_dict(params)
    return model.to(dev)


def cast_model(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The model itself in its own dtype, else a copy cast to `dtype`
    (the bf16 scoring path casts params the way the JAX package does)."""
    p = next(model.parameters())
    if p.dtype == dtype:
        return model
    return copy.deepcopy(model).to(dtype)
