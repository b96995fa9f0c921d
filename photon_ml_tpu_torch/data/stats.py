"""Per-feature summary statistics of a padded sparse batch (port of
``photon_ml_tpu/data/stats.py``; its dense-batch branch waits for
``DenseBatch``).

Reference: photon-ml .../stat/BasicStatistics.scala:42 (wraps MLlib
Statistics.colStats) and BasicStatisticalSummary.scala:80 (mean/variance/
count/numNonzeros/max/min/normL1/normL2/meanAbs with NaN-variance repair at
:94-120). These feed the normalization contexts and the feature
summarization output.

Entries accumulate with ``index_add_`` over (row, nnz) pairs; weights
gate padding rows. Counts are unweighted, as in the reference (MLlib
colStats is unweighted; weights only enter training objectives).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photon_ml_tpu_torch.data.batch import SparseBatch

Tensor = torch.Tensor


class BasicStatisticalSummary(NamedTuple):
    mean: Tensor  # [d]
    variance: Tensor  # [d]
    count: Tensor  # scalar: number of (real) examples
    num_nonzeros: Tensor  # [d]
    max: Tensor  # [d]
    min: Tensor  # [d]
    norm_l1: Tensor  # [d]
    norm_l2: Tensor  # [d]
    mean_abs: Tensor  # [d]

    @property
    def max_magnitude(self) -> Tensor:
        return torch.maximum(self.max.abs(), self.min.abs())

    @property
    def std(self) -> Tensor:
        return torch.sqrt(self.variance)


def sparse_moments(batch: SparseBatch, dim: int):
    """Accumulable raw moments of one sparse batch: (n, s1, s2, l1, nnz,
    mx, mn) with mx/mn over NONZERO entries only (+-inf when untouched).
    Chunked summaries sum the first five and max/min the last two across
    chunks, then call :func:`finalize_summary` once: the implicit-zero
    fold needs the global n and nnz."""
    real = (batch.weights > 0).float()
    n = real.sum()
    flat_ix = batch.indices.reshape(-1).long()
    flat_v = batch.values.reshape(-1)
    row_real = real.repeat_interleave(batch.indices.shape[1])
    v = flat_v * row_real
    # padding slots carry index 0 / value 0 and must not touch feature 0
    nonzero_slot = (row_real > 0) & (flat_v != 0)

    def add(src: Tensor) -> Tensor:
        return src.new_zeros(dim).index_add_(0, flat_ix, src)

    s1, s2, l1 = add(v), add(v * v), add(v.abs())
    nnz = add(nonzero_slot.float())
    inf = float("inf")
    mx = flat_v.new_full((dim,), -inf).scatter_reduce_(
        0, flat_ix, flat_v.masked_fill(~nonzero_slot, -inf), reduce="amax"
    )
    mn = flat_v.new_full((dim,), inf).scatter_reduce_(
        0, flat_ix, flat_v.masked_fill(~nonzero_slot, inf), reduce="amin"
    )
    return n, s1, s2, l1, nnz, mx, mn


def finalize_summary(n, s1, s2, l1, nnz, mx, mn) -> BasicStatisticalSummary:
    """Raw (possibly chunk-accumulated) moments -> summary, with the
    implicit-zero fold (zeros, explicit or implicit, enter max/min via the
    nnz < n test, contributing the same 0) and the NaN-variance repair of
    BasicStatisticalSummary.scala:94-120."""
    has_implicit_zero = nnz < n
    mx = torch.where(has_implicit_zero, torch.clamp_min(mx, 0.0), mx)
    mn = torch.where(has_implicit_zero, torch.clamp_max(mn, 0.0), mn)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    mn = torch.where(torch.isfinite(mn), mn, torch.zeros_like(mn))
    safe_n = torch.clamp_min(n, 1.0)
    mean = s1 / safe_n
    var = (s2 - safe_n * mean * mean) / torch.clamp_min(safe_n - 1.0, 1.0)
    var = torch.where(torch.isfinite(var) & (var >= 0), var, torch.ones_like(var))
    return BasicStatisticalSummary(
        mean=mean,
        variance=var,
        count=n,
        num_nonzeros=nnz,
        max=mx,
        min=mn,
        norm_l1=l1,
        norm_l2=torch.sqrt(s2),
        mean_abs=l1 / safe_n,
    )


def compute_summary(batch: SparseBatch, dim: int) -> BasicStatisticalSummary:
    """colStats analog. Implicit zeros count toward mean/variance/min/max
    exactly as in MLlib's sparse colStats."""
    if not isinstance(batch, SparseBatch):
        raise TypeError(
            f"compute_summary takes a SparseBatch, got {type(batch).__name__}"
        )
    return finalize_summary(*sparse_moments(batch, dim))
