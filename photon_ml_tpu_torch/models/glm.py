"""Generalized linear models (port of ``photon_ml_tpu/models/glm.py``).

Reference: photon-ml .../supervised/model/GeneralizedLinearModel.scala
(computeScore at :47, computeMeanFunctionWithOffset at :56-66).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from photon_ml_tpu_torch.data.batch import Batch, SparseBatch, dense_dot, sparse_dot
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.task import TaskType

Tensor = torch.Tensor


def compute_scores(coef: Tensor, batch: Batch) -> Tensor:
    """Raw margins WITHOUT offsets: features . coef."""
    if isinstance(batch, SparseBatch):
        return sparse_dot(batch, coef)
    return dense_dot(batch, coef)


def compute_margins(coef: Tensor, batch: Batch) -> Tensor:
    """Margins including offsets: features . coef + offset."""
    return compute_scores(coef, batch) + batch.offsets


def compute_means(task: TaskType, coef: Tensor, batch: Batch) -> Tensor:
    """Mean response with offsets: sigmoid / identity / exp / raw margin."""
    return loss_for_task(task).mean(compute_margins(coef, batch))


@dataclass(frozen=True)
class GeneralizedLinearModel:
    task: TaskType
    coefficients: Coefficients

    @property
    def means(self) -> Tensor:
        return self.coefficients.means

    def score(self, batch: Batch) -> Tensor:
        return compute_scores(self.means, batch)

    def mean(self, batch: Batch) -> Tensor:
        return compute_means(self.task, self.means, batch)

    def update_coefficients(self, coefficients: Coefficients) -> "GeneralizedLinearModel":
        return replace(self, coefficients=coefficients)

    def predict_class(self, batch: Batch, threshold: float = 0.5) -> Tensor:
        """Binary 0/1 prediction; classification tasks only."""
        if not self.task.is_classification:
            raise ValueError(f"{self.task} is not a classification task")
        if self.task == TaskType.LOGISTIC_REGRESSION:
            return (self.mean(batch) > threshold).float()
        return (compute_margins(self.means, batch) > 0.0).float()


def logistic_regression_model(coefficients: Coefficients) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(TaskType.LOGISTIC_REGRESSION, coefficients)


def linear_regression_model(coefficients: Coefficients) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(TaskType.LINEAR_REGRESSION, coefficients)


def poisson_regression_model(coefficients: Coefficients) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(TaskType.POISSON_REGRESSION, coefficients)


def smoothed_hinge_svm_model(coefficients: Coefficients) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM, coefficients)


def create_model(task: TaskType, coefficients: Coefficients) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(task, coefficients)
