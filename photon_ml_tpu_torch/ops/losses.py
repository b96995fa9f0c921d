"""Pointwise GLM losses: ``(margin, label) -> (loss, d/dz, d2/dz2)``.

Port of ``photon_ml_tpu/ops/losses.py`` (reference: photon-ml
.../function/glm/PointwiseLossFunction.scala and its logistic, squared,
Poisson and smoothed-hinge implementations). Elementwise over tensors, in
the same numerically stable float32 forms.

Label conventions match the reference: logistic and smoothed hinge take
labels in {0, 1}; squared and Poisson take real / non-negative labels.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from photon_ml_tpu_torch.task import TaskType

Tensor = torch.Tensor


class PointwiseLoss(NamedTuple):
    """A pointwise loss: value, first and second derivative w.r.t. margin.

    ``has_hessian=False`` marks a once-differentiable loss (smoothed
    hinge) whose ``d2`` must not be trusted.
    """

    name: str
    value: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    mean: Callable[[Tensor], Tensor]
    has_hessian: bool = True


def _sigmoid(z: Tensor) -> Tensor:
    return torch.where(
        z >= 0,
        1.0 / (1.0 + torch.exp(-z)),
        torch.exp(z) / (1.0 + torch.exp(z)),
    )


def _log1pexp(z: Tensor) -> Tensor:
    """log(1 + exp(z)), stable for large |z|."""
    return torch.where(
        z > 0, z + torch.log1p(torch.exp(-z)), torch.log1p(torch.exp(z))
    )


# --- logistic: log(1 + e^z) - y z ------------------------------------------

def _logistic_value(z: Tensor, y: Tensor) -> Tensor:
    return _log1pexp(z) - y * z


def _logistic_d1(z: Tensor, y: Tensor) -> Tensor:
    return _sigmoid(z) - y


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = _sigmoid(z)
    return s * (1.0 - s)


LOGISTIC = PointwiseLoss(
    name="logistic",
    value=_logistic_value,
    d1=_logistic_d1,
    d2=_logistic_d2,
    mean=_sigmoid,
)


# --- squared: 0.5 (z - y)^2 ------------------------------------------------

def _squared_value(z: Tensor, y: Tensor) -> Tensor:
    d = z - y
    return 0.5 * d * d


LINEAR = PointwiseLoss(
    name="squared",
    value=_squared_value,
    d1=lambda z, y: z - y,
    d2=lambda z, y: torch.ones_like(z),
    mean=lambda z: z,
)


# --- poisson: e^z - y z ----------------------------------------------------

POISSON = PointwiseLoss(
    name="poisson",
    value=lambda z, y: torch.exp(z) - y * z,
    d1=lambda z, y: torch.exp(z) - y,
    d2=lambda z, y: torch.exp(z),
    mean=lambda z: torch.exp(z),
)


# --- smoothed hinge (Rennie), t = (2y - 1) z --------------------------------
#   t >= 1: 0 ;  t <= 0: 0.5 - t ;  else 0.5 (1 - t)^2

def _smoothed_hinge_value(z: Tensor, y: Tensor) -> Tensor:
    t = (2.0 * y - 1.0) * z
    return torch.where(
        t >= 1.0,
        torch.zeros_like(t),
        torch.where(t <= 0.0, 0.5 - t, 0.5 * (1.0 - t) ** 2),
    )


def _smoothed_hinge_d1(z: Tensor, y: Tensor) -> Tensor:
    s = 2.0 * y - 1.0
    t = s * z
    dt = torch.where(
        t >= 1.0,
        torch.zeros_like(t),
        torch.where(t <= 0.0, -torch.ones_like(t), t - 1.0),
    )
    return s * dt


SMOOTHED_HINGE = PointwiseLoss(
    name="smoothed_hinge",
    value=_smoothed_hinge_value,
    d1=_smoothed_hinge_d1,
    d2=lambda z, y: torch.zeros_like(z),
    mean=lambda z: z,
    has_hessian=False,
)


LOSSES_BY_TASK = {
    TaskType.LOGISTIC_REGRESSION: LOGISTIC,
    TaskType.LINEAR_REGRESSION: LINEAR,
    TaskType.POISSON_REGRESSION: POISSON,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SMOOTHED_HINGE,
}


def loss_for_task(task: TaskType) -> PointwiseLoss:
    return LOSSES_BY_TASK[task]
