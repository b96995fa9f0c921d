"""Streaming (bounded-memory) evaluation accumulators (port of
``photon_ml_tpu/evaluation/streaming.py``).

Reference: validation is one more pass over an RDD (Driver.scala:329-413,
Evaluation.scala:54-125). The in-memory evaluators (``metrics.py``) sort
the whole score vector; these fold one chunk at a time, in numpy on the
host:

- RMSE and the pointwise losses are exact (weighted sums commute);
- AUC is a fixed-bin histogram over sigmoid(margin): AUC is invariant
  under a strictly monotone map, so binning loses only the orderings
  within a bin (well under 1e-3 of the exact AUC at 4096 bins on
  realistic scores); ties within a bin get the exact evaluator's 0.5.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.task import TaskType


def _np64(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class StreamingAUC:
    """Weighted AUC from per-class histograms over sigmoid(margin) bins:
    sum_b pos_b (neg_below_b + neg_b / 2) / (P N), the exact Mann-Whitney
    statistic of scores rounded to their bins. Histograms merge by
    addition."""

    def __init__(self, num_bins: int = 4096):
        self.num_bins = int(num_bins)
        self.pos = np.zeros(self.num_bins, np.float64)
        self.neg = np.zeros(self.num_bins, np.float64)

    def update(self, margins, labels, weights) -> None:
        s, y, w = _np64(margins), _np64(labels), _np64(weights)
        real = w > 0
        if not real.any():
            return
        s, y, w = s[real], y[real], w[real]
        # monotone squash to (0, 1), stable for large |z|
        p = np.where(
            s >= 0, 1.0 / (1.0 + np.exp(-s)),
            np.exp(np.minimum(s, 0)) / (1.0 + np.exp(np.minimum(s, 0))),
        )
        b = np.clip((p * self.num_bins).astype(np.int64), 0, self.num_bins - 1)
        np.add.at(self.pos, b, np.where(y > 0.5, w, 0.0))
        np.add.at(self.neg, b, np.where(y <= 0.5, w, 0.0))

    def merge(self, other: "StreamingAUC") -> "StreamingAUC":
        assert other.num_bins == self.num_bins
        self.pos += other.pos
        self.neg += other.neg
        return self

    def result(self) -> float:
        wp = self.pos.sum()
        wn = self.neg.sum()
        if wp <= 0 or wn <= 0:
            return float("nan")  # degenerate input, as the exact path
        neg_below = np.cumsum(self.neg) - self.neg
        u = np.sum(self.pos * (neg_below + 0.5 * self.neg))
        return float(u / (wp * wn))


class StreamingRMSE:
    """Exact weighted RMSE over mean-space predictions."""

    def __init__(self):
        self.sq_sum = 0.0
        self.w_sum = 0.0

    def update(self, predictions, labels, weights) -> None:
        p, y, w = _np64(predictions), _np64(labels), _np64(weights)
        d = p - y
        self.sq_sum += float(np.sum(w * d * d))
        self.w_sum += float(np.sum(w))

    def result(self) -> float:
        return float(np.sqrt(self.sq_sum / max(self.w_sum, 1e-30)))


class StreamingMeanLoss:
    """Exact weighted mean pointwise loss (margins in)."""

    def __init__(self, loss: PointwiseLoss):
        self.loss = loss
        self.loss_sum = 0.0
        self.w_sum = 0.0

    def update(self, margins, labels, weights) -> None:
        margins, labels, weights = (torch.as_tensor(a) for a in (margins, labels, weights))
        total = torch.sum(weights * self.loss.value(margins, labels))
        # one counted fetch per chunk: the accumulator lives on the host
        self.loss_sum += float(overlap.device_get(total))
        self.w_sum += float(np.sum(_np64(weights)))

    def result(self) -> float:
        return float(self.loss_sum / max(self.w_sum, 1e-30))


def glm_streaming_metrics(task: TaskType, loss: PointwiseLoss) -> Dict[str, object]:
    """The GLM driver's metric set as streaming accumulators, by name."""
    accs: Dict[str, object] = {f"{loss.name}_loss": StreamingMeanLoss(loss)}
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        accs["AUC"] = StreamingAUC()
    if task in (TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION):
        accs["RMSE"] = StreamingRMSE()
    return accs


def update_glm_metrics(
    accs: Dict[str, object], loss: PointwiseLoss, margins, labels, weights
) -> None:
    """Fold one chunk (tensors) into every accumulator; RMSE takes the
    loss's mean function of the margins, as the in-memory driver does."""
    for acc in accs.values():
        if isinstance(acc, StreamingRMSE):
            acc.update(loss.mean(margins), labels, weights)
        else:
            acc.update(margins, labels, weights)


def finalize_metrics(accs: Dict[str, object]) -> Dict[str, float]:
    return {name: acc.result() for name, acc in accs.items()}
