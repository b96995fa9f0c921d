"""Model coefficients: means + optional per-coefficient variances.

Port of ``photon_ml_tpu/models/coefficients.py`` (reference: photon-ml
.../model/Coefficients.scala:33).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class Coefficients:
    means: Tensor  # [d]
    variances: Optional[Tensor] = None  # [d] or None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def l2_norm(self) -> Tensor:
        return torch.linalg.vector_norm(self.means, dim=-1)

    def l1_norm(self) -> Tensor:
        return torch.sum(torch.abs(self.means), dim=-1)

    @staticmethod
    def zeros(dim: int, dtype=torch.float32, device=None) -> "Coefficients":
        return Coefficients(means=torch.zeros(dim, dtype=dtype, device=device))


@dataclass(frozen=True)
class CoefficientSummary:
    """Running summary of one coefficient (or, elementwise, of a vector of
    them) across bootstrap replicates (CoefficientSummary.scala): count,
    mean, ``m2`` (Welford's sum of squared deviations), min and max."""

    count: Tensor
    mean: Tensor
    m2: Tensor
    min: Tensor
    max: Tensor

    @staticmethod
    def empty(dtype=torch.float32, shape=(), device=None) -> "CoefficientSummary":
        def full(v):
            return torch.full(shape, v, dtype=dtype, device=device)

        return CoefficientSummary(
            count=full(0.0), mean=full(0.0), m2=full(0.0),
            min=full(float("inf")), max=full(-float("inf")),
        )

    def accumulate(self, x: Tensor) -> "CoefficientSummary":
        """The summary with one more replicate ``x`` (Welford's update)."""
        count = self.count + 1.0
        delta = x - self.mean
        mean = self.mean + delta / count
        m2 = self.m2 + delta * (x - mean)
        return CoefficientSummary(
            count=count, mean=mean, m2=m2,
            min=torch.minimum(self.min, x), max=torch.maximum(self.max, x),
        )

    def merge(self, other: "CoefficientSummary") -> "CoefficientSummary":
        """The summary of both sets of replicates (Chan et al.'s pairwise
        combination of two Welford summaries)."""
        count = self.count + other.count
        safe = torch.where(count > 0, count, torch.ones_like(count))
        delta = other.mean - self.mean
        mean = torch.where(count > 0, self.mean + delta * (other.count / safe), self.mean)
        m2 = self.m2 + other.m2 + delta * delta * (self.count * other.count / safe)
        return CoefficientSummary(
            count=count, mean=mean, m2=m2,
            min=torch.minimum(self.min, other.min), max=torch.maximum(self.max, other.max),
        )

    @property
    def variance(self) -> Tensor:
        """The unbiased sample variance; 0 below two replicates."""
        return torch.where(
            self.count > 1, self.m2 / torch.clamp(self.count - 1.0, min=1.0),
            torch.zeros_like(self.m2),
        )
