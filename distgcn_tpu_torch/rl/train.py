"""Replay training: TF1-exact Adam and the per-sample replay trainer.

Port of `distgcn_tpu/rl/train.py`. The GDPG replay (mwis_gdpg_call.py:
707-769) and its DQN flavour (mwis_dqn_call.py:151-186) apply one Adam
update per memorized sample, in order: sample i sees the parameters that
sample i-1 produced. The JAX package scans the minibatch on the device;
here a Python loop runs forward, `torch.autograd.grad` and the TF1 update
per sample. The samples are never summed into one gradient (that is the
sharded train step's semantics, not the replay's).

Loss parity (GCN2_DQN._loss, gcn/models.py:613-626):
    loss = sqrt(mean((out[:, :1] - labels)^2)) + weight_decay * l2(layer-1
    vars),  l2(v) = sum(v^2)/2 (tf.nn.l2_loss)
with the mean taken over the real (unpadded) nodes.

Target construction parity (mwis_gdpg_call.py:723-756):
    target_f = act_vals;  target_f[action, :] += reward
    labels_i = target_f_i / std(all targets) - mean(all targets) + 1.0
(DQN flavour instead assigns target_f[solution] = reward, no
standardization.) Targets are built in float64 on the host, then cast to
float32 labels on the padded batch.

Optimizer state is explicit, as optax's is: ``{"count": int, "m": {name:
tensor}, "v": {name: tensor}}`` keyed by the model's parameter names
(``gc1.w_0``), so `rl/checkpoint.py` maps it leaf for leaf onto the JAX
package's ``opt_state`` tree. `make_supervised_diver_step` is the
supervised GCNDeepDiver step (hindsight-min weighted CE, one TF1 Adam
update per batch).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple

import numpy as np
import torch

from distgcn_tpu_torch.agents import build_state_arrays
from distgcn_tpu_torch.core.graph import GraphBatch, pad_bucket


class GradientTransformation(NamedTuple):
    """optax's interface: ``init(params) -> state`` and
    ``update(grads, state) -> (updates, state)`` over name -> tensor maps."""
    init: Callable
    update: Callable


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable[[int], torch.Tensor]:
    """``optax.exponential_decay(..., staircase=True)`` in float32:
    ``init * decay ** floor(count / steps)``, ``init`` at count <= 0."""
    def schedule(count: int) -> torch.Tensor:
        if count <= 0:
            return _f32(init_value)
        p = torch.floor(_f32(count) / transition_steps)
        return _f32(init_value) * torch.pow(_f32(decay_rate), p)
    return schedule


def tf1_adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8) -> GradientTransformation:
    """Bit-faithful `tf.compat.v1.train.AdamOptimizer` update rule.

    TF1 Adam (unlike `torch.optim.Adam` and `optax.adam`, which add eps to
    the bias-CORRECTED sqrt(v_hat)) folds the bias corrections into the
    step size and adds eps to the raw sqrt(v):

        lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
        p   -= lr_t * m_t / (sqrt(v_t) + eps)

    ``t``, ``b1^t``, ``b2^t`` and ``lr_t`` are float32, as in the JAX
    package. `learning_rate` may be a schedule (callable of the 0-based
    update count, read BEFORE the increment, as TF1's global_step is).
    The moments are updated with `torch._foreach_*` ops in the JAX
    package's operation order, IN PLACE: the returned state holds the
    same ``m`` and ``v`` tensors. (On the card each out-of-place
    `_foreach` op allocates a tensor per parameter, and those allocations
    took most of the update's host time.)
    """
    def init_fn(params: Mapping[str, torch.Tensor]) -> Dict:
        return {"count": 0,
                "m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    def step_size(count: int) -> float:
        lr = (learning_rate(count) if callable(learning_rate)
              else _f32(learning_rate))
        t = _f32(count + 1)
        lr_t = lr * torch.sqrt(1.0 - torch.pow(_f32(b2), t)) / (
            1.0 - torch.pow(_f32(b1), t))
        return float(lr_t)

    @torch.no_grad()
    def update_fn(grads: Mapping[str, torch.Tensor], state: Dict):
        keys = list(state["m"])
        g = [grads[k] for k in keys]
        m = [state["m"][k] for k in keys]
        v = [state["v"][k] for k in keys]
        tmp = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, tmp)                # b1*m + (1-b1)*g
        torch._foreach_copy_(tmp, g)
        torch._foreach_mul_(tmp, 1.0 - b2)
        torch._foreach_mul_(tmp, g)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, tmp)                # b2*v + (1-b2)*g*g
        torch._foreach_copy_(tmp, v)
        torch._foreach_sqrt_(tmp)
        torch._foreach_add_(tmp, eps)              # sqrt(v) + eps
        updates = torch._foreach_mul(m, -step_size(state["count"]))
        torch._foreach_div_(updates, tmp)
        return dict(zip(keys, updates)), {
            "count": state["count"] + 1, "m": state["m"], "v": state["v"]}

    return GradientTransformation(init_fn, update_fn)


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  updates: Mapping[str, torch.Tensor]) -> None:
    """``p += u`` in place (optax.apply_updates on the model's tensors)."""
    keys = list(updates)
    torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])


def make_optimizer(learning_rate: float, learning_decay: float = 1.0
                   ) -> GradientTransformation:
    """TF1-exact Adam with the reference's staircase exponential decay
    (gcn/models.py:602-609: decay every 5000 steps)."""
    if learning_decay < 1.0:
        return tf1_adam(exponential_decay(learning_rate, 5000,
                                          learning_decay))
    return tf1_adam(learning_rate)


def first_layer_l2(model: torch.nn.Module) -> torch.Tensor:
    """``sum(v^2)/2`` over the first layer's parameters, bias included
    (gcn/models.py:614-616): ``gc1``, else the first layer name in
    sorted order, as the JAX package picks it."""
    named = sorted(model.named_parameters())
    layers = sorted({k.split(".")[0] for k, _ in named})
    first = "gc1" if "gc1" in layers else layers[0]
    return sum((p ** 2).sum() / 2.0 for k, p in named
               if k.split(".")[0] == first)


def replay_loss(model, features, supports, labels, mask,
                weight_decay: float) -> torch.Tensor:
    """One sample's loss: features [N, F], supports [S, N, N], labels
    [N, 1], mask [N] float (1 on real nodes)."""
    out = model(features[None], supports[None])[0]          # [N, out_dim]
    err = (out[:, :1] - labels) ** 2
    mse = (err[:, 0] * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return torch.sqrt(mse) + weight_decay * first_layer_l2(model)


class ReplayTrainer:
    """Owns the optimizer state and runs the per-sample replay updates on
    the agent's model, on the agent's device."""

    def __init__(self, agent, style: str = "gdpg"):
        self.agent = agent
        self.style = style
        self.optimizer = make_optimizer(agent.flags.learning_rate,
                                        agent.flags.learning_decay)
        self.opt_state = self.optimizer.init(
            dict(agent.model.named_parameters()))

    def prepare(self, minibatch: List[tuple]):
        """minibatch entries: (compact_state, act_vals, action, next_state,
        reward) — the `agents.MWISSolver.memorize` format. Returns the
        padded batch on the agent's device: (adj [K, N, N] int8, wts [K, N],
        mask [K, N] float32, labels [K, N, 1] float32)."""
        agent = self.agent
        adjs, wtss, targets = [], [], []
        for state, act_vals, action, _next, reward in minibatch:
            av = np.array(act_vals, dtype=np.float64, copy=True)
            if av.ndim == 1:
                av = av[:, None]
            idx = np.asarray(action, dtype=int)
            if self.style == "gdpg":
                av[idx, :] += reward
            elif self.style == "dqn_origin":
                # mwis_dqn_origin.py:216: target_f[solu] = reward + wts_norm
                # with wts_norm = wts[solu]/greedy_util; greedy_util isn't
                # memorized but reward = total/greedy, so w/greedy =
                # w * reward / total
                w = np.asarray(state["wts"], dtype=np.float64).flatten()[idx]
                tot = float(w.sum())
                scale = reward / tot if tot > 0 else 0.0
                av[idx, :] = reward + (w * scale)[:, None]
            else:  # dqn flavour: assignment (mwis_dqn_call.py:168-171)
                av[idx, :] = reward
            adjs.append(state["adj"])
            wtss.append(np.asarray(state["wts"]).flatten())
            targets.append(av)

        if self.style == "gdpg":
            flat = np.concatenate([t.flatten() for t in targets])
            b_avg = float(np.mean(flat))
            b_std = float(np.std(flat))
            std = b_std if b_std > 0 else 1.0
            targets = [t / std - b_avg + 1.0 for t in targets]

        bucket = pad_bucket(max(a.shape[0] for a in adjs), agent.flags.pad_to)
        gb = GraphBatch.from_scipy(adjs, wtss, pad_to=bucket,
                                   device=agent.device)
        b, n = gb.wts.shape
        labels = np.zeros((b, n, 1), dtype=np.float32)
        for i, t in enumerate(targets):
            labels[i, : t.shape[0], 0] = t[:, 0]
        return (gb.adj, gb.wts, gb.mask.to(torch.float32),
                torch.from_numpy(labels).to(agent.device))

    def step(self, adj, wts, mask, labels) -> torch.Tensor:
        """One TF1 Adam update per sample, in order. Returns the per-sample
        losses [K] (each at the parameters before its own update)."""
        model = self.agent.model
        flags = self.agent.flags
        features, supports = build_state_arrays(
            adj, wts, mask > 0, flags.feature_size, flags.max_degree,
            flags.predict, self.agent.feature_mode)
        params = dict(model.named_parameters())
        losses = []
        for i in range(adj.shape[0]):
            loss = replay_loss(model, features[i], supports[i], labels[i],
                               mask[i], flags.weight_decay)
            grads = torch.autograd.grad(loss, list(params.values()))
            updates, self.opt_state = self.optimizer.update(
                dict(zip(params, grads)), self.opt_state)
            apply_updates(params, updates)
            losses.append(loss.detach())
        return torch.stack(losses)

    def train_minibatch(self, minibatch: List[tuple]) -> float:
        """Replay a minibatch; returns the mean per-sample loss."""
        return float(self.step(*self.prepare(minibatch)).mean())


def make_supervised_diver_step(model, optimizer: GradientTransformation,
                               diver_num: int):
    """Supervised step for GCN_DEEP_DIVER training: the mean over the batch
    of the hindsight-min weighted CE over the diver heads
    (gcn/models.py:327-334) on labeled graphs (the datasets' `mwis_label`),
    through autograd and one `optimizer` update of `model`'s parameters in
    place.

    Returns step(opt_state, features, supports, mask, labels01,
    node_weights) -> (opt_state, loss), loss a 0-d tensor taken at the
    parameters before the update.
    """
    from distgcn_tpu_torch.rl.losses import hindsight_diver_ce

    def step(opt_state, features, supports, mask, labels01, node_w):
        params = dict(model.named_parameters())
        out = model(features, supports, mask)
        m = mask.to(out.dtype)
        # weight only real nodes; the CE is node-weight-normalized
        w = node_w * m
        losses = [hindsight_diver_ce(out[i], labels01[i], w[i], diver_num)
                  for i in range(out.shape[0])]
        loss = torch.stack(losses).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, opt_state = optimizer.update(dict(zip(params, grads)),
                                              opt_state)
        apply_updates(params, updates)
        return opt_state, loss.detach()

    return step
