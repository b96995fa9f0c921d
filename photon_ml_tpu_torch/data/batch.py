"""Padded sparse example batches (port of ``photon_ml_tpu/data/batch.py``).

Reference data model: photon-ml .../data/LabeledPoint.scala (label, sparse
features, offset, weight; margin = features . coef + offset).

A batch is a padded gather-format block ("padded COO rows"):

- ``indices[n, k]`` int32: feature ids per row, padded with 0
- ``values[n, k]`` float32: feature values per row, padded with 0.0
- ``labels/offsets/weights[n]``: padded rows carry ``weight == 0``, which
  zeroes their contribution to loss, gradient, Hessian and metrics.

A dense batch (small feature dimensions) is a plain ``[n, d]`` matrix
whose products are matrix products (``torch.matmul``, as XLA's in the JAX
package; with TF32 off they stay float32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.ops import fixed_order
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclass(frozen=True)
class SparseBatch:
    """Row i: sum_j values[i, j] * w[indices[i, j]]."""

    indices: Tensor  # int32 [n, k]
    values: Tensor  # float32 [n, k]
    labels: Tensor  # float32 [n]
    offsets: Tensor  # float32 [n]
    weights: Tensor  # float32 [n]; 0 for padding rows

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def nnz_per_row(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "SparseBatch":
        return SparseBatch(
            *(t.to(device) for t in (
                self.indices, self.values, self.labels, self.offsets,
                self.weights,
            ))
        )


@dataclass(frozen=True)
class DenseBatch:
    """Row i: features[i] . w."""

    features: Tensor  # float [n, d]
    labels: Tensor  # [n]
    offsets: Tensor  # [n]
    weights: Tensor  # [n]; 0 for padding rows

    @property
    def num_rows(self) -> int:
        return self.features.shape[0]

    @property
    def device(self) -> torch.device:
        return self.features.device

    def to(self, device) -> "DenseBatch":
        return DenseBatch(
            *(t.to(device) for t in (
                self.features, self.labels, self.offsets, self.weights,
            ))
        )


Batch = Union[SparseBatch, DenseBatch]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_sparse_batch(
    rows: Sequence[Tuple[Sequence[int], Sequence[float]]],
    labels: Sequence[float],
    offsets: Optional[Sequence[float]] = None,
    weights: Optional[Sequence[float]] = None,
    *,
    pad_rows_to: int = 8,
    pad_nnz_to: int = 8,
    max_nnz: Optional[int] = None,
    device: DeviceLike = None,
) -> SparseBatch:
    """Build a padded SparseBatch from per-row (indices, values) lists,
    padded exactly as the reference pads (rows and nnz rounded up to
    ``pad_rows_to`` / ``pad_nnz_to``)."""
    dev = resolve_device(device)
    n = len(rows)
    if n == 0:
        raise ValueError("empty batch")
    k = max((len(ix) for ix, _ in rows), default=1)
    if max_nnz is not None:
        k = min(k, max_nnz)
    k = max(_round_up(max(k, 1), pad_nnz_to), pad_nnz_to)
    n_pad = max(_round_up(n, pad_rows_to), pad_rows_to)

    indices = np.zeros((n_pad, k), dtype=np.int32)
    values = np.zeros((n_pad, k), dtype=np.float32)
    for i, (ix, vs) in enumerate(rows):
        m = min(len(ix), k)
        indices[i, :m] = np.asarray(ix[:m], dtype=np.int32)
        values[i, :m] = np.asarray(vs[:m], dtype=np.float32)
    lab = np.zeros((n_pad,), dtype=np.float32)
    lab[:n] = np.asarray(labels, dtype=np.float32)
    off = np.zeros((n_pad,), dtype=np.float32)
    if offsets is not None:
        off[:n] = np.asarray(offsets, dtype=np.float32)
    wgt = np.zeros((n_pad,), dtype=np.float32)
    wgt[:n] = 1.0 if weights is None else np.asarray(weights, dtype=np.float32)
    return sparse_batch_from_arrays(indices, values, lab, off, wgt, device=dev)


def make_dense_batch(
    features: np.ndarray,
    labels: Sequence[float],
    offsets: Optional[Sequence[float]] = None,
    weights: Optional[Sequence[float]] = None,
    *,
    pad_rows_to: int = 8,
    dtype=np.float32,
    device: DeviceLike = None,
) -> DenseBatch:
    """A DenseBatch with its rows zero-padded (weight 0) to a multiple of
    ``pad_rows_to``, as the reference pads them."""
    features = np.asarray(features, dtype=dtype)
    n, d = features.shape
    n_pad = max(_round_up(n, pad_rows_to), pad_rows_to)
    f = np.zeros((n_pad, d), dtype=dtype)
    f[:n] = features
    lab = np.zeros((n_pad,), dtype=dtype)
    lab[:n] = np.asarray(labels, dtype=dtype)
    off = np.zeros((n_pad,), dtype=dtype)
    if offsets is not None:
        off[:n] = np.asarray(offsets, dtype=dtype)
    wgt = np.zeros((n_pad,), dtype=dtype)
    wgt[:n] = 1.0 if weights is None else np.asarray(weights, dtype=dtype)
    dev = resolve_device(device)
    return DenseBatch(*(torch.as_tensor(a, device=dev) for a in (f, lab, off, wgt)))


def sparse_batch_from_arrays(
    indices: np.ndarray,
    values: np.ndarray,
    labels: np.ndarray,
    offsets: np.ndarray,
    weights: np.ndarray,
    *,
    device: DeviceLike = None,
) -> SparseBatch:
    """Already padded numpy arrays -> SparseBatch on ``device`` (the bulk
    path for large synthetic or loaded data)."""
    dev = resolve_device(device)
    return SparseBatch(
        indices=torch.as_tensor(np.asarray(indices, np.int32), device=dev),
        values=torch.as_tensor(np.asarray(values, np.float32), device=dev),
        labels=torch.as_tensor(np.asarray(labels, np.float32), device=dev),
        offsets=torch.as_tensor(np.asarray(offsets, np.float32), device=dev),
        weights=torch.as_tensor(np.asarray(weights, np.float32), device=dev),
    )


def sparse_dot(batch: SparseBatch, w_eff: Tensor) -> Tensor:
    """Per-row sparse dot product: w [d] -> [n], or a bank [G, d] ->
    [G, n]."""
    gathered = w_eff.index_select(-1, batch.indices.reshape(-1))
    return (batch.values * gathered.unflatten(-1, batch.indices.shape)).sum(dim=-1)


def dense_dot(batch: DenseBatch, w: Tensor) -> Tensor:
    """``features . w``: w [d] -> [n], or a bank [G, d] -> [G, n]."""
    if w.dim() == 1:
        return torch.matmul(batch.features, w)
    return torch.matmul(w, batch.features.T)


def dense_weighted_sum(batch: DenseBatch, row_coef: Tensor, features=None) -> Tensor:
    """``features^T . c``: c [n] -> [d], or [G, n] -> [G, d] (``features``
    overrides the batch's, as the Hessian diagonal squares them)."""
    f = batch.features if features is None else features
    if row_coef.dim() == 1:
        return torch.matmul(f.T, row_coef)
    return torch.matmul(row_coef, f)


def row_sum(x: Tensor) -> Tensor:
    """Per-row sum over the last axis by an explicit pairwise tree: the
    row is zero-padded to a power of two and halved by elementwise adds.
    The order of the adds depends on the row's length only — not on the
    number of rows, nor on how a device's reduction kernel lays out its
    threads for that shape — so a row sums to the same bits in a batch of
    1 or of 65,536, on the CPU or the card (``.sum(dim=-1)`` on the card
    does not: its thread layout follows the batch's shape)."""
    k = x.shape[-1]
    width = 1 << max(k - 1, 0).bit_length()
    if width != k:
        x = torch.nn.functional.pad(x, (0, width - k))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def fe_row_scores(w: Tensor, indices: Tensor, values: Tensor) -> Tensor:
    """A fixed effect's row scores ``sum_j values[i, j] * w[indices[i, j]]``
    in :func:`row_sum`'s order: the GAME batch scorer's and the serving
    programs' one function."""
    gathered = w.index_select(-1, indices.reshape(-1)).unflatten(-1, indices.shape)
    return row_sum(values * gathered)


def re_row_scores(bank: Tensor, codes: Tensor, indices: Tensor, values: Tensor) -> Tensor:
    """A random effect's row scores from its ``[E, d]`` bank: the ``[n,
    k]`` gather ``bank[codes, indices]``, 0 where the entity code is -1."""
    codes = codes.long()
    score = row_sum(values * bank[codes.clamp_min(0)[:, None], indices.long()])
    return torch.where(codes >= 0, score, 0.0)


def mf_row_scores(row_latent: Tensor, col_latent: Tensor, rows: Tensor, cols: Tensor) -> Tensor:
    """A matrix factorization's row scores, the latent dot product, 0
    where either entity code is -1."""
    rows, cols = rows.long(), cols.long()
    r = row_latent[rows.clamp_min(0)]
    c = col_latent[cols.clamp_min(0)]
    return torch.where((rows >= 0) & (cols >= 0), row_sum(r * c), 0.0)


def sparse_scatter_add(batch: SparseBatch, row_coef: Tensor, dim: int) -> Tensor:
    """sum_i row_coef[i] * x_i as a dense [dim] vector, or [G, dim] for a
    bank of row coefficients [G, n] (the reference's per-datum axpy,
    ValueAndGradientAggregator.scala:133-154), summed in a fixed order
    (``ops/fixed_order.py``)."""
    contrib = (batch.values * row_coef[..., None]).flatten(-2)
    out = row_coef.new_zeros(row_coef.shape[:-1] + (dim,))
    return fixed_order.index_add(
        out, batch.indices.reshape(-1), contrib,
        plan=fixed_order.cached_plan(batch.indices) if out.is_cuda else None,
    )
