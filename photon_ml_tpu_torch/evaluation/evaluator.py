"""Evaluator family: typed metrics with string parsing and a comparison
direction (port of ``photon_ml_tpu/evaluation/evaluator.py``).

Reference: photon-ml .../evaluation/Evaluator.scala:47-56 (scores joined
with label, offset and weight; the metric; ``betterThan``),
EvaluatorType.scala:63-77 (string forms, with the sharded variants
``precision@5:queryId`` and ``AUC:documentId``), RMSEEvaluator, the loss
evaluators, ShardedPrecisionAtKEvaluator.scala, and Evaluation.scala's
MetricsMap for plain GLM validation.

An evaluator is a function over aligned tensors (scores, labels, weights
and, for the sharded metrics, dense group ids): the reference's join is
gone because the rows already line up.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import torch

from photon_ml_tpu_torch.evaluation import metrics as M
from photon_ml_tpu_torch.ops.losses import LINEAR, LOGISTIC, POISSON, SMOOTHED_HINGE

Tensor = torch.Tensor

_LOSS_BY_NAME = {
    "LOGISTIC_LOSS": LOGISTIC,
    "SQUARED_LOSS": LINEAR,
    "POISSON_LOSS": POISSON,
    "SMOOTHED_HINGE_LOSS": SMOOTHED_HINGE,
}

_PRECISION_RE = re.compile(r"^PRECISION@(\d+):(.+)$", re.IGNORECASE)
_SHARDED_AUC_RE = re.compile(r"^AUC:(.+)$", re.IGNORECASE)


@dataclass(frozen=True)
class EvaluatorType:
    """``name`` in {AUC, AUPR, RMSE, *_LOSS, PRECISION_AT_K}; a sharded
    metric carries its id column's name (``id_type``)."""

    name: str
    k: Optional[int] = None
    id_type: Optional[str] = None  # e.g. "queryId": set = sharded

    @property
    def is_sharded(self) -> bool:
        return self.id_type is not None

    @property
    def maximize(self) -> bool:
        return self.name in ("AUC", "AUPR", "PRECISION_AT_K")

    def better_than(self, a: float, b: float) -> bool:
        return a > b if self.maximize else a < b

    @classmethod
    def parse(cls, s: str) -> "EvaluatorType":
        t = s.strip()
        m = _PRECISION_RE.match(t)
        if m:
            return cls("PRECISION_AT_K", k=int(m.group(1)), id_type=m.group(2))
        m = _SHARDED_AUC_RE.match(t)
        if m:
            return cls("AUC", id_type=m.group(1))
        u = t.upper()
        if u in ("AUC", "AUPR", "RMSE") or u in _LOSS_BY_NAME:
            return cls(u)
        raise ValueError(f"unrecognized evaluator type: {s!r}")

    def render(self) -> str:
        if self.name == "PRECISION_AT_K":
            return f"PRECISION@{self.k}:{self.id_type}"
        if self.id_type is not None:
            return f"{self.name}:{self.id_type}"
        return self.name


@dataclass(frozen=True)
class Evaluator:
    """One metric over (scores, labels, weights[, group_ids]). ``scores``
    already include the offsets (callers pass margins); RMSE callers apply
    the mean function first."""

    etype: EvaluatorType
    num_groups: Optional[int] = None  # required by the sharded metrics

    def evaluate(
        self,
        scores: Tensor,
        labels: Tensor,
        weights: Tensor,
        group_ids: Optional[Tensor] = None,
    ) -> Tensor:
        et = self.etype
        if et.is_sharded:
            if group_ids is None or self.num_groups is None:
                raise ValueError(f"{et.render()} requires group_ids and num_groups")
            if et.name == "AUC":
                return M.sharded_auc(group_ids, scores, labels, weights, self.num_groups)
            return M.sharded_precision_at_k(
                et.k, group_ids, scores, labels, weights, self.num_groups
            )
        if et.name == "AUC":
            return M.area_under_roc_curve(scores, labels, weights)
        if et.name == "AUPR":
            return M.area_under_precision_recall_curve(scores, labels, weights)
        if et.name == "RMSE":
            return M.root_mean_squared_error(scores, labels, weights)
        return M.mean_pointwise_loss(_LOSS_BY_NAME[et.name], scores, labels, weights)

    def better_than(self, a: float, b: float) -> bool:
        return self.etype.better_than(a, b)


def select_best_model(models_by_lambda, evaluate_fn, maximize: bool):
    """(lambda, model, metric) with the best validation metric
    (ModelSelection.scala:36-63); the first of equal metrics wins."""
    best = None
    for lam, model in models_by_lambda.items():
        metric = float(evaluate_fn(model))
        if (
            best is None
            or (maximize and metric > best[2])
            or (not maximize and metric < best[2])
        ):
            best = (lam, model, metric)
    return best
