"""The scatter GLM objective: value / gradient / Hv / Hessian diagonal.

Port of ``photon_ml_tpu/ops/objective.py`` (reference: photon-ml
.../function/ValueAndGradientAggregator.scala:133-250,
HessianVectorAggregator.scala:137-152, HessianDiagonalAggregator.scala).
Over a SparseBatch margins gather with ``index_select`` and reductions
scatter in a fixed order; this is the port's ``kernel="scatter"`` path
and a second oracle for the tiled objective. Over a DenseBatch both are
matrix products, as the reference's dense branches.

Semantics match the reference: total = sum_i weight_i * loss_i (no 1/n),
the L2 term lambda/2 * ||w||^2 is added once, L1 is not part of the
objective, and normalization is applied algebraically.

Every method takes one coefficient vector ``[d]`` with a scalar
``l2_weight``, or a bank ``[G, d]`` with an ``l2_weight`` per member
``[G]`` (the batched λ-grid: what the reference gets from ``jax.vmap``).
Values come back as ``[]`` or ``[G]``, vectors as ``[d]`` or ``[G, d]``.
With ``group`` (a data-parallel shard of the rows) each evaluation's
partial sums are summed over the group in one all-reduce, as the
reference's ``axis_name`` psums them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.data.batch import (
    Batch,
    SparseBatch,
    dense_dot,
    dense_weighted_sum,
    sparse_dot,
    sparse_scatter_add,
)
from photon_ml_tpu_torch.ops import fixed_order
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationContext,
    identity_context,
)
from photon_ml_tpu_torch.optim.common import sum_over

Tensor = torch.Tensor


def squared_norm(coef: Tensor) -> Tensor:
    """||w||^2 of a vector, or of each member of a bank."""
    if coef.dim() == 1:
        return torch.dot(coef, coef)
    return (coef * coef).sum(dim=-1)


def per_member(weight, coef: Tensor):
    """A weight as a factor of ``coef``: a per-member ``[G]`` weight becomes
    a column ``[G, 1]`` against a bank; a scalar stays as it is."""
    if torch.is_tensor(weight) and weight.dim() == 1:
        return weight[:, None]
    return weight


def sum_partials(group, *parts: Tensor, scalars: int = 0):
    """The objective's partial sums, summed over the ranks of ``group`` in
    one all-reduce (``optim.common.sum_over``); as they are without one."""
    return list(parts) if group is None else sum_over(group, *parts, scalars=scalars)


def _dot(batch: Batch, w: Tensor) -> Tensor:
    if isinstance(batch, SparseBatch):
        return sparse_dot(batch, w)
    return dense_dot(batch, w)


@dataclass(frozen=True)
class GLMObjective:
    """A weighted GLM objective over a SparseBatch or a DenseBatch of
    dimension ``dim``.

    ``group``: a process group whose ranks each hold a shard of the rows
    (the data-parallel fit, the reference's ``with_axis``); every partial
    sum is then summed over it before the L2 term is added."""

    loss: PointwiseLoss
    dim: int
    norm: NormalizationContext = field(default_factory=identity_context)
    group: Optional[object] = None

    def margins(self, coef: Tensor, batch: Batch) -> Tensor:
        """z_i = x_eff_i . w_eff + offset_i (normalized-space margin)."""
        w_eff = self.norm.effective_coefficients(coef)
        raw = _dot(batch, w_eff)
        return raw - self.norm.shift_dot(w_eff)[..., None] + batch.offsets

    def _weighted_feature_sum(self, batch: Batch, row_coef: Tensor) -> Tensor:
        """sum_i row_coef[i] * x_i as a dense [dim] (or [G, dim]) vector."""
        if isinstance(batch, SparseBatch):
            return sparse_scatter_add(batch, row_coef, self.dim)
        return dense_weighted_sum(batch, row_coef)

    def value(self, coef: Tensor, batch: Batch, l2_weight=0.0) -> Tensor:
        z = self.margins(coef, batch)
        val = torch.sum(batch.weights * self.loss.value(z, batch.labels), dim=-1)
        (val,) = sum_partials(self.group, val, scalars=1)
        return val + 0.5 * l2_weight * squared_norm(coef)

    def value_and_gradient(
        self, coef: Tensor, batch: Batch, l2_weight=0.0
    ) -> Tuple[Tensor, Tensor]:
        """grad = factor * (vectorSum - shift * prefactorSum) + lambda * w."""
        z = self.margins(coef, batch)
        c = batch.weights * self.loss.d1(z, batch.labels)
        value_sum = torch.sum(batch.weights * self.loss.value(z, batch.labels), dim=-1)
        vector_sum = self._weighted_feature_sum(batch, c)
        value_sum, prefactor_sum, vector_sum = sum_partials(
            self.group, value_sum, torch.sum(c, dim=-1), vector_sum, scalars=2
        )
        grad = self.norm.unshift_gradient(vector_sum, prefactor_sum)
        value = value_sum + 0.5 * l2_weight * squared_norm(coef)
        return value, grad + per_member(l2_weight, coef) * coef

    def gradient(self, coef: Tensor, batch: Batch, l2_weight=0.0) -> Tensor:
        return self.value_and_gradient(coef, batch, l2_weight)[1]

    def hessian_vector(
        self, coef: Tensor, direction: Tensor, batch: Batch, l2_weight=0.0
    ) -> Tensor:
        """H(w) @ d (HessianVectorAggregator.scala:137-152)."""
        d_eff = self.norm.effective_coefficients(direction)
        z = self.margins(coef, batch)
        zd = _dot(batch, d_eff) - self.norm.shift_dot(d_eff)[..., None]
        c = batch.weights * self.loss.d2(z, batch.labels) * zd
        vector_sum = self._weighted_feature_sum(batch, c)
        prefactor_sum, vector_sum = sum_partials(
            self.group, torch.sum(c, dim=-1), vector_sum, scalars=1
        )
        hv = self.norm.unshift_gradient(vector_sum, prefactor_sum)
        return hv + per_member(l2_weight, direction) * direction

    def hessian_diagonal(self, coef: Tensor, batch: Batch, l2_weight=0.0) -> Tensor:
        """diag(H) for variances 1/(Hdiag + eps). With x_eff = (x - shift) *
        factor: diag_j = factor_j^2 (S2_j - 2 shift_j S1_j + shift_j^2 S0),
        c_i = weight_i l''_i, S2 = sum c x^2, S1 = sum c x, S0 = sum c."""
        z = self.margins(coef, batch)
        c = batch.weights * self.loss.d2(z, batch.labels)
        if isinstance(batch, SparseBatch):
            diag = fixed_order.index_add(
                c.new_zeros(c.shape[:-1] + (self.dim,)), batch.indices.reshape(-1),
                (batch.values**2 * c[..., None]).flatten(-2),
                plan=fixed_order.cached_plan(batch.indices) if c.is_cuda else None,
            )
        else:
            diag = dense_weighted_sum(batch, c, batch.features**2)
        if self.norm.shift is not None:
            s1 = self._weighted_feature_sum(batch, c)
            s0, s1, diag = sum_partials(
                self.group, torch.sum(c, dim=-1)[..., None], s1, diag
            )
            diag = diag - 2.0 * self.norm.shift * s1 + self.norm.shift**2 * s0
        else:
            (diag,) = sum_partials(self.group, diag)
        if self.norm.factor is not None:
            diag = diag * self.norm.factor**2
        return diag + per_member(l2_weight, coef)


# -- the per-chunk partials of the streamed objectives (io/streaming.py):
# each is the scatter objective at l2 = 0; the streamed objective sums them
# over the chunks and adds the L2 term once.


def partial_value_and_gradient(objective: GLMObjective, coef: Tensor, batch: SparseBatch):
    """(value, gradient) of one chunk at l2 = 0."""
    return objective.value_and_gradient(coef, batch, 0.0)


def partial_hessian_vector(
    objective: GLMObjective, coef: Tensor, direction: Tensor, batch: SparseBatch
) -> Tensor:
    """H(w) @ d of one chunk at l2 = 0 (a streamed TRON CG step)."""
    return objective.hessian_vector(coef, direction, batch, 0.0)


def partial_hessian_diagonal(objective: GLMObjective, coef: Tensor, batch: SparseBatch) -> Tensor:
    """diag(H) of one chunk at l2 = 0 (the streamed variance pass)."""
    return objective.hessian_diagonal(coef, batch, 0.0)
