"""Evaluation metrics: AUC, AUPR, RMSE, weighted losses, AIC, F1 and
precision@k, plain and per group, padding-aware (weight-0 rows vanish).
Port of ``photon_ml_tpu/evaluation/metrics.py``.

Reference: photon-ml Evaluation.scala:54-125,
evaluation/AreaUnderROCCurveLocalEvaluator.scala,
PrecisionAtKLocalEvaluator.scala, the sharded evaluators and the loss
evaluators. Each curve is one sort plus cumulative sums with exact tie
handling (tied scores share credit, as MLlib's threshold-grouped curves
do); the grouped metrics are a lexicographic sort plus segmented sums.
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


def _scatter_add(n: int, index: Tensor, src: Tensor) -> Tensor:
    return torch.zeros(n, dtype=src.dtype, device=src.device).index_add_(0, index, src)


def area_under_precision_recall_curve(
    scores: Tensor, labels: Tensor, weights: Tensor
) -> Tensor:
    """Weighted AUPR, one point per distinct score, trapezoids between
    recall levels from a first point (0, precision at the top score)
    (MLlib PRCurve semantics)."""
    n = scores.shape[0]
    order = torch.argsort(-scores, stable=True)
    s, y, w = scores[order], labels[order], weights[order]
    pos_w = w * (y > 0.5)
    g = _tie_groups(s)
    group_pos = _scatter_add(n, g, pos_w)
    group_tot = _scatter_add(n, g, w)
    cum_pos_g = torch.cumsum(group_pos, 0)
    cum_tot_g = torch.cumsum(group_tot, 0)
    wp = torch.sum(pos_w)
    precision = torch.where(
        cum_tot_g > 0, cum_pos_g / torch.clamp_min(cum_tot_g, 1e-30), 0.0
    )
    recall = torch.where(wp > 0, cum_pos_g / torch.clamp_min(wp, 1e-30), 0.0)
    prev_recall = torch.cat([torch.zeros_like(recall[:1]), recall[:-1]])
    prev_precision = torch.cat([precision[:1], precision[:-1]])
    seg_area = torch.where(
        group_tot > 0, (recall - prev_recall) * 0.5 * (precision + prev_precision), 0.0
    )
    return torch.sum(seg_area)


def akaike_information_criterion(log_likelihood_total, num_parameters):
    """AIC = 2k - 2 ln L, with the total log-loss as -ln L (Evaluation.scala)."""
    return 2.0 * num_parameters + 2.0 * log_likelihood_total


def precision_at_k(k: int, scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Unweighted precision@k over one group: the share of positives among
    the k best-scored rows (weights only mark rows as real)."""
    valid = weights > 0
    masked = torch.where(valid, scores, -torch.inf)
    topk = torch.argsort(-masked, stable=True)[:k]
    hits = (labels[topk] > 0.5) & valid[topk]
    denom = torch.clamp(torch.sum(valid), max=k)
    return torch.sum(hits) / torch.clamp_min(denom, 1)


def f1_score(predictions: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted F1 of binary 0/1 predictions."""
    p, t = predictions > 0.5, labels > 0.5
    tp = torch.sum(weights * (p & t))
    fp = torch.sum(weights * (p & ~t))
    fn = torch.sum(weights * (~p & t))
    return 2.0 * tp / torch.clamp_min(2.0 * tp + fp + fn, 1e-30)


def _lexsort(primary: Tensor, secondary: Tensor) -> Tensor:
    """Order by ``primary``, ties by ``secondary`` (numpy's
    ``lexsort((secondary, primary))``): two stable sorts."""
    order = torch.argsort(secondary, stable=True)
    return order[torch.argsort(primary[order], stable=True)]


def sharded_auc(
    group_ids: Tensor, scores: Tensor, labels: Tensor, weights: Tensor,
    num_groups: int,
) -> Tensor:
    """Mean AUC over the groups that hold both classes
    (ShardedAreaUnderROCCurveEvaluator: group by id, AUC per group,
    unweighted mean). ``group_ids`` are dense ints in [0, num_groups)."""
    n = scores.shape[0]
    order = _lexsort(group_ids, scores)
    gid, s, y, w = group_ids[order].long(), scores[order], labels[order], weights[order]
    pos_w = w * (y > 0.5)
    neg_w = w * (y <= 0.5)
    # tie groups keyed by (group, score)
    new_group = torch.ones(n, dtype=torch.bool, device=s.device)
    new_group[1:] = (gid[1:] != gid[:-1]) | (s[1:] != s[:-1])
    tg = torch.cumsum(new_group.long(), 0) - 1
    group_neg = _scatter_add(n, tg, neg_w)
    glob_excl = torch.cumsum(group_neg, 0) - group_neg
    seg_neg_total = _scatter_add(num_groups, gid, neg_w)
    seg_base = torch.cumsum(seg_neg_total, 0) - seg_neg_total
    tg_seg = torch.zeros(n, dtype=gid.dtype, device=gid.device).scatter_reduce_(
        0, tg, gid, reduce="amax"
    )
    within_excl = glob_excl - seg_base[tg_seg]
    credit = within_excl[tg] + 0.5 * group_neg[tg]
    seg_u = _scatter_add(num_groups, gid, pos_w * credit)
    seg_pos = _scatter_add(num_groups, gid, pos_w)
    valid = (seg_pos > 0) & (seg_neg_total > 0)
    auc = torch.where(valid, seg_u / torch.clamp_min(seg_pos * seg_neg_total, 1e-30), 0.0)
    return torch.sum(auc) / torch.clamp_min(torch.sum(valid), 1)


def sharded_precision_at_k(
    k: int, group_ids: Tensor, scores: Tensor, labels: Tensor, weights: Tensor,
    num_groups: int,
) -> Tensor:
    """Mean precision@k over the groups (ShardedPrecisionAtKEvaluator)."""
    n = scores.shape[0]
    valid_row = weights > 0
    masked = torch.where(valid_row, scores, -torch.inf)
    order = _lexsort(group_ids, -masked)
    gid, y, v = group_ids[order].long(), labels[order], valid_row[order]
    pos = torch.arange(n, device=gid.device)
    is_first = torch.ones(n, dtype=torch.bool, device=gid.device)
    is_first[1:] = gid[1:] != gid[:-1]
    seg_start = torch.full((num_groups,), n, dtype=pos.dtype, device=pos.device).scatter_reduce_(
        0, gid, torch.where(is_first, pos, n), reduce="amin"
    )
    rank = pos - seg_start[gid]
    in_topk = (rank < k) & v
    f32 = torch.float32
    seg_hits = _scatter_add(num_groups, gid, (in_topk & (y > 0.5)).to(f32))
    seg_count = _scatter_add(num_groups, gid, v.to(f32))
    denom = torch.clamp(seg_count, max=float(k))
    group_exists = seg_count > 0
    prec = torch.where(group_exists, seg_hits / torch.clamp_min(denom, 1.0), 0.0)
    return torch.sum(prec) / torch.clamp_min(torch.sum(group_exists), 1)
