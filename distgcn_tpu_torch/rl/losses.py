"""Losses and metrics — parity with gcn/metrics.py and the model losses.

Port of `distgcn_tpu/rl/losses.py`:

- softmax CE / node-weighted CE (gcn/metrics.py:3-16)
- accuracy / F1 (+ masked variants) (gcn/metrics.py:19-62)
- hindsight-min diver CE: GCN_DEEP_DIVER trains 2-class heads and
  backpropagates only the best head (gcn/models.py:327-334)
- RMSE Q-losses: GCN_DQN head-0 RMSE + min-over-extra-heads L1
  (gcn/models.py:462-479), GCN2_DQN scalar RMSE (gcn/models.py:613-626)
"""

from __future__ import annotations

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def softmax_cross_entropy(logits, labels):
    """Mean softmax CE (gcn/metrics.py:3-8). labels one-hot [..., C]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(labels * logp).sum(dim=-1).mean()


def weighted_softmax_cross_entropy(logits, labels, node_weights):
    """Node-weight-normalized CE (gcn/metrics.py:10-16): per-node CE scaled
    by w / mean(w)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -(labels * logp).sum(dim=-1)
    w = node_weights / torch.clamp(node_weights.mean(), min=1e-12)
    return (ce * w).mean()


def accuracy(logits, labels):
    """Argmax accuracy (gcn/metrics.py:19-23)."""
    return _f32(logits.argmax(-1) == labels.argmax(-1)).mean()


def f1_score(logits, labels, positive_class: int = 1):
    """Precision/recall F1 from argmax (gcn/metrics.py:26-43)."""
    pred = logits.argmax(-1) == positive_class
    true = labels.argmax(-1) == positive_class
    tp = (pred & true).sum()
    fp = (pred & ~true).sum()
    fn = (~pred & true).sum()
    precision = tp / torch.clamp(tp + fp, min=1)
    recall = tp / torch.clamp(tp + fn, min=1)
    return 2 * precision * recall / torch.clamp(precision + recall,
                                                min=1e-12)


def f1_precision_recall(logits, labels):
    """The reference's exact my_f1 triple (gcn/metrics.py:26-43): tp/fp/fn
    as MEANS over nodes (not counts — same ratios), precision/recall/F1 from
    them. An epsilon guards the 0/0 cases the reference leaves as nan."""
    correct = logits.argmax(-1) == labels.argmax(-1)
    pos = labels[..., 1] > 0
    neg = labels[..., 0] > 0
    tp = _f32(correct & pos).mean()
    fp = _f32(~correct & neg).mean()
    fn = _f32(~correct & pos).mean()
    precision = tp / torch.clamp(tp + fp, min=1e-12)
    recall = tp / torch.clamp(tp + fn, min=1e-12)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return f1, precision, recall


def masked_softmax_cross_entropy(logits, labels, mask):
    """CE over masked nodes (gcn/metrics.py:46-53)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -(labels * logp).sum(dim=-1)
    m = _f32(mask)
    m = m / torch.clamp(m.mean(), min=1e-12)
    return (ce * m).mean()


def masked_accuracy(logits, labels, mask):
    """gcn/metrics.py:56-62."""
    correct = _f32(logits.argmax(-1) == labels.argmax(-1))
    m = _f32(mask)
    m = m / torch.clamp(m.mean(), min=1e-12)
    return (correct * m).mean()


def diver_heads(logits, diver_num: int):
    """Reference diver head layout (gcn/models.py:330-332, :398-400): head k
    occupies the INTERLEAVED column pair (2k, 2k+1) — class 0 (out of IS) at
    even, class 1 (in IS) at odd columns. Returns [..., diver, 2]."""
    return logits[..., : 2 * diver_num].reshape(
        logits.shape[:-1] + (diver_num, 2))


def _onehot(labels01):
    return torch.stack([1.0 - labels01, labels01], dim=-1)


def hindsight_diver_ce(logits, labels01, node_weights, diver_num: int):
    """GCN_DEEP_DIVER hindsight loss (gcn/models.py:327-334): the 2*diver
    logits form diver_num (neg, pos) heads at interleaved column pairs
    (`diver_heads`); each head incurs a weighted CE against the 0/1 IS
    labels; only the minimum-loss head counts.

    logits: [N, 2*diver]; labels01: [N] in {0,1}; node_weights: [N].
    """
    onehot = _onehot(labels01)
    heads = diver_heads(logits, diver_num)
    losses = [weighted_softmax_cross_entropy(heads[:, k], onehot,
                                             node_weights)
              for k in range(diver_num)]
    return torch.stack(losses).min()


def hindsight_diver_accuracy(logits, labels01, diver_num: int):
    """Max-over-heads accuracy (gcn/models.py:344-349)."""
    onehot = _onehot(labels01)
    heads = diver_heads(logits, diver_num)
    return torch.stack([accuracy(heads[:, k], onehot)
                        for k in range(diver_num)]).max()


def hindsight_diver_f1(logits, labels01, diver_num: int):
    """Max-over-heads F1/precision/recall (gcn/models.py:351-361): each
    metric maxed over heads INDEPENDENTLY, as the reference's per-metric
    reduce_max chain does. Returns (f1, precision, recall)."""
    onehot = _onehot(labels01)
    heads = diver_heads(logits, diver_num)
    triples = [f1_precision_recall(heads[:, k], onehot)
               for k in range(diver_num)]
    return tuple(torch.stack(col).max() for col in zip(*triples))


def gcn_dqn_loss(outputs, labels, diver_num: int):
    """GCN_DQN regression loss (gcn/models.py:462-479): RMSE on the first
    head + min with mean-L1 of each shifted extra head."""
    out_dim = labels.shape[-1]
    loss = torch.sqrt(((outputs[:, :out_dim] - labels) ** 2).mean())
    for i in range(1, diver_num):
        l1 = (outputs[:, i: i + out_dim] - labels).abs().mean()
        loss = torch.minimum(loss, l1)
    return loss


def gcn2_dqn_loss(outputs, labels):
    """GCN2_DQN RMSE (gcn/models.py:613-626)."""
    return torch.sqrt(((outputs[:, : labels.shape[-1]] - labels) ** 2)
                      .mean())
