"""Evaluation metrics: AUC, RMSE and weighted pointwise losses, padding-aware
(weight-0 rows vanish). Port of part of
``photon_ml_tpu/evaluation/metrics.py``.

Reference: photon-ml Evaluation.scala:54-125 and
evaluation/AreaUnderROCCurveLocalEvaluator.scala. AUC is one sort plus
cumulative sums with exact tie handling (tied scores share credit, as
MLlib's threshold-grouped curves do).
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor


def _tie_groups(sorted_keys: Tensor) -> Tensor:
    """Group index per element of a sorted tensor; equal keys share one."""
    new_group = torch.ones_like(sorted_keys, dtype=torch.bool)
    new_group[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return torch.cumsum(new_group.long(), 0) - 1


def area_under_roc_curve(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted AUC (Mann-Whitney U / total mass):
    sum_pos w_p (W_neg_below(p) + 0.5 W_neg_tied(p)) / (Wp Wn).
    NaN when either class has zero weight."""
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    s, y, w = scores[order], labels[order], weights[order]
    pos_w = w * (y > 0.5)
    neg_w = w * (y <= 0.5)
    g = _tie_groups(s)
    group_neg = torch.zeros(n, dtype=w.dtype, device=w.device).index_add_(0, g, neg_w)
    excl_cum_neg = torch.cumsum(group_neg, 0) - group_neg
    credit = excl_cum_neg[g] + 0.5 * group_neg[g]
    u = torch.sum(pos_w * credit)
    return u / (torch.sum(pos_w) * torch.sum(neg_w))


def root_mean_squared_error(predictions: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    d = predictions - labels
    return torch.sqrt(
        torch.sum(weights * d * d) / torch.clamp_min(torch.sum(weights), 1e-30)
    )


def mean_pointwise_loss(
    loss: PointwiseLoss, margins: Tensor, labels: Tensor, weights: Tensor
) -> Tensor:
    """Weighted mean of a pointwise loss over margins."""
    total = torch.sum(weights * loss.value(margins, labels))
    return total / torch.clamp_min(torch.sum(weights), 1e-30)


def total_pointwise_loss(
    loss: PointwiseLoss, margins: Tensor, labels: Tensor, weights: Tensor
) -> Tensor:
    return torch.sum(weights * loss.value(margins, labels))
