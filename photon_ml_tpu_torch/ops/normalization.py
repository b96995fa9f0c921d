"""Feature normalization as (shift, factor) algebra, never densifying data.

Port of ``photon_ml_tpu/ops/normalization.py`` (reference: photon-ml
.../normalization/NormalizationContext.scala:119-157). Normalization
``x -> (x - shift) * factor`` is applied algebraically inside the
objective:

    margin = x . (factor * w) - shift . (factor * w)
    grad   = factor * (sum_i c_i x_i - shift * sum_i c_i)

The intercept column (if any) has ``shift = 0, factor = 1``. Every
method takes one coefficient vector ``[d]`` or a bank ``[G, d]`` (the
batched λ-grid); per-vector scalars come back as ``[]`` or ``[G]``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import torch

Tensor = torch.Tensor


class NormalizationType(enum.Enum):
    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


@dataclass(frozen=True)
class NormalizationContext:
    """Optional shift/factor vectors; None means identity."""

    factor: Optional[Tensor] = None  # [d] or None
    shift: Optional[Tensor] = None  # [d] or None

    @property
    def is_identity(self) -> bool:
        return self.factor is None and self.shift is None

    def to(self, device) -> "NormalizationContext":
        return NormalizationContext(
            None if self.factor is None else self.factor.to(device),
            None if self.shift is None else self.shift.to(device),
        )

    def effective_coefficients(self, coef: Tensor) -> Tensor:
        """w_eff = factor * w (margin side)."""
        return coef if self.factor is None else coef * self.factor

    def shift_dot(self, coef_eff: Tensor) -> Tensor:
        """shift . w_eff, the scalar subtracted from every margin."""
        if self.shift is None:
            return coef_eff.new_zeros(coef_eff.shape[:-1])
        return coef_eff @ self.shift

    def unshift_gradient(self, vector_sum: Tensor, prefactor_sum: Tensor) -> Tensor:
        """(vectorSum - shift * prefactor) * factor
        (ValueAndGradientAggregator.scala:199-221)."""
        g = vector_sum
        if self.shift is not None:
            g = g - self.shift * prefactor_sum[..., None]
        if self.factor is not None:
            g = g * self.factor
        return g

    def model_to_original_space(self, coef: Tensor) -> Tensor:
        """w_orig = factor * w'; the caller adjusts the intercept slot."""
        return coef if self.factor is None else coef * self.factor

    def intercept_adjustment(self, coef: Tensor) -> Tensor:
        """Amount to add to the intercept when mapping back to original space."""
        if self.shift is None:
            return coef.new_zeros(coef.shape[:-1])
        return -(self.effective_coefficients(coef) @ self.shift)


def identity_context() -> NormalizationContext:
    return NormalizationContext(None, None)


def build_normalization(
    norm_type: NormalizationType,
    *,
    mean: Tensor,
    std: Tensor,
    max_magnitude: Tensor,
    intercept_index: Optional[int] = None,
) -> NormalizationContext:
    """Build shift/factor from feature summary stats; the intercept slot
    keeps factor 1 and shift 0 (NormalizationContext.scala:119-157)."""
    mean = torch.as_tensor(mean)
    std = torch.as_tensor(std)
    max_magnitude = torch.as_tensor(max_magnitude)
    one = torch.ones_like(mean)
    safe_std = torch.where(std > 0, std, torch.ones_like(std))
    safe_max = torch.where(
        max_magnitude > 0, max_magnitude, torch.ones_like(max_magnitude)
    )

    if norm_type == NormalizationType.NONE:
        return identity_context()
    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factor, shift = one / safe_std, None
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factor, shift = one / safe_max, None
    elif norm_type == NormalizationType.STANDARDIZATION:
        factor, shift = one / safe_std, mean.clone()
    else:  # pragma: no cover
        raise ValueError(norm_type)

    if intercept_index is not None:
        factor[intercept_index] = 1.0
        if shift is not None:
            shift[intercept_index] = 0.0
    return NormalizationContext(factor=factor, shift=shift)
