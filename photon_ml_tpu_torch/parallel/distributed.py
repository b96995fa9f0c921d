"""Feature-sharded GLM fits on a (data, model) mesh of ranks (port of the
feature-sharded half of ``photon_ml_tpu/parallel/distributed.py``).

Coefficient vectors too large to replicate are cut into ``model_shards``
contiguous blocks of ``block_dim`` features. Rank (d, m) holds cell
(d, m): the entries of data shard d whose features fall in block m
(``FeatureShardedTiledBatch`` for the tiled kernel, or
:class:`FeatureShardedSparseBatch` for the scatter path), coefficient
block m, and its own optimizer state for that block. Per evaluation:

- the cell's z-pass gives block m's partial margins of shard d's rows,
  summed over the model group (the reference's ``psum`` over "model");
- the cell's g-pass gives shard d's part of block m's gradient, summed
  over the data group (``psum`` over "data");
- the optimizers' inner products and norms are partials summed over the
  model group (``MeshReductions``), and every rank follows world rank 0's
  control flags.

On the tiled layout the passes are K1 (one vector) and K2 (a ``[G,
block_dim]`` bank of the batched λ-grid), as on one card. The three
block-local closures are written once for both layouts: the reference's
``tiled_block_local_*`` (``ops/tiled_sparse.py:990-1156``) and
``_sparse_block_*`` (``parallel/distributed.py:357-480``) differ only in
their passes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import (
    SparseBatch,
    sparse_batch_from_arrays,
    sparse_dot,
    sparse_scatter_add,
)
from photon_ml_tpu_torch.ops import fixed_order
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import per_member, squared_norm
from photon_ml_tpu_torch.optim.common import (
    BoxConstraints,
    MeshReductions,
    OptResult,
    all_gather_last,
    sum_over,
)
from photon_ml_tpu_torch.optim.lbfgs import minimize_lbfgs, minimize_owlqn
from photon_ml_tpu_torch.optim.tron import minimize_tron
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, ProcessMesh
from photon_ml_tpu_torch.parallel.multihost import sum_in_rank_order
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# The sparse (scatter) layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FeatureShardedSparseBatch:
    """ONE rank's cell of the reference's ``FeatureShardedSparseBatch``:
    data shard ``data_index``'s rows with their entries of feature block
    ``model_index``, as a SparseBatch whose indices are block-local
    (``[n_loc, kb]``; ``kb`` is the reference's, the largest count of one
    row's entries in one block over the whole batch, padded)."""

    batch: SparseBatch
    block_dim: int
    data_index: int
    model_index: int

    @property
    def labels(self) -> Tensor:
        return self.batch.labels

    @property
    def offsets(self) -> Tensor:
        return self.batch.offsets

    @property
    def weights(self) -> Tensor:
        return self.batch.weights

    def z_pass(self, x_block: Tensor) -> Tensor:
        return sparse_dot(self.batch, x_block)

    def g_pass(self, c: Tensor) -> Tensor:
        return sparse_scatter_add(self.batch, c, self.block_dim)

    def g_sq_pass(self, c: Tensor) -> Tensor:
        b = self.batch
        return fixed_order.index_add(
            c.new_zeros(c.shape[:-1] + (self.block_dim,)), b.indices.reshape(-1),
            (b.values**2 * c[..., None]).flatten(-2),
            plan=fixed_order.cached_plan(b.indices) if c.is_cuda else None,
        )


def feature_shard_sparse_batch(
    batch: SparseBatch, dim: int, data_shards: int, model_shards: int,
    data_index: int, model_index: int, *, pad_nnz_to: int = 8,
    device: DeviceLike = None,
) -> Tuple[FeatureShardedSparseBatch, int]:
    """SparseBatch -> (this rank's cell of the reference's
    ``feature_shard_sparse_batch`` layout, block_dim). Rows are padded
    (weight 0) to a multiple of ``data_shards`` and split into contiguous
    shards; ``block_dim = ceil(dim / model_shards)``. A row's entries in
    the block keep their order; padding slots are (index 0, value 0)."""
    idx = batch.indices.cpu().numpy()
    val = batch.values.cpu().numpy()
    n, k = idx.shape
    n_loc = -(-n // data_shards)
    block_dim = -(-dim // model_shards)
    real = val != 0.0
    block_of = np.where(real, idx // block_dim, 0)
    counts = np.bincount(
        (block_of * n + np.arange(n)[:, None])[real], minlength=model_shards * n
    )
    kb = max(int(counts.max(initial=0)), 1)
    kb = -(-kb // pad_nnz_to) * pad_nnz_to

    lo, hi = data_index * n_loc, min((data_index + 1) * n_loc, n)
    mine = real[lo:hi] & (block_of[lo:hi] == model_index)
    slot = np.cumsum(mine, axis=1) - 1
    r, j = np.nonzero(mine)
    out_idx = np.zeros((n_loc, kb), np.int32)
    out_val = np.zeros((n_loc, kb), np.float32)
    out_idx[r, slot[r, j]] = idx[lo:hi][r, j] - model_index * block_dim
    out_val[r, slot[r, j]] = val[lo:hi][r, j]

    def rows(t: Tensor) -> np.ndarray:
        out = np.zeros(n_loc, np.float32)
        out[: hi - lo] = t.cpu().numpy()[lo:hi]
        return out

    cell = sparse_batch_from_arrays(
        out_idx, out_val, rows(batch.labels), rows(batch.offsets),
        rows(batch.weights), device=resolve_device(device),
    )
    return FeatureShardedSparseBatch(cell, block_dim, data_index, model_index), block_dim


# ---------------------------------------------------------------------------
# Block-local closures (either layout)
# ---------------------------------------------------------------------------


def _z_eff(cell, norm: NormalizationContext, x_block: Tensor) -> Tensor:
    """The block's partial margins of ``x_block`` in effective space: the
    z-pass of ``factor * x`` minus this block's part of ``shift . x_eff``."""
    x_eff = norm.effective_coefficients(x_block)
    z = cell.z_pass(x_eff)
    return z if norm.shift is None else z - norm.shift_dot(x_eff)[..., None]


def block_local_vg(
    loss, cell, data_group, model_group, l2, norm: NormalizationContext,
) -> Callable[[Tensor], Tuple[Tensor, Tensor]]:
    """(value, block gradient) of a coefficient block ``[block_dim]`` or a
    bank ``[G, block_dim]`` over this rank's ``cell`` (the reference's
    ``tiled_block_local_vg`` / ``_sparse_block_vg``). ``norm`` holds this
    block's slices of the shift and factor. Two all-reduces per
    evaluation: the partial margins with ``||w_block||^2`` over the model
    group, then the value, the prefactor and the gradient over the data
    group."""

    def vg(w_block: Tensor):
        w_sq, z = sum_over(
            model_group, squared_norm(w_block), _z_eff(cell, norm, w_block),
            scalars=1,
        )
        z = z + cell.offsets
        c = cell.weights * loss.d1(z, cell.labels)
        value, prefactor, grad = sum_over(
            data_group,
            torch.sum(cell.weights * loss.value(z, cell.labels), dim=-1),
            torch.sum(c, dim=-1), cell.g_pass(c), scalars=2,
        )
        grad = norm.unshift_gradient(grad, prefactor)
        return value + 0.5 * l2 * w_sq, grad + per_member(l2, w_block) * w_block

    return vg


def block_local_hvp_factory(
    loss, cell, data_group, model_group, l2, norm: NormalizationContext,
) -> Callable[[Tensor], Callable[[Tensor], Tensor]]:
    """``factory(w_block) -> (d_block -> H(w) d)`` over this rank's cell
    (the reference's ``tiled_block_local_hvp_factory`` /
    ``_sparse_block_hvp_factory``): the margins of w and the second
    derivatives are computed once per outer TRON trip; each CG step is one
    z-pass summed over the model group and one g-pass summed over the data
    group (the Hv pass reuses both schedules)."""

    def factory(w_block: Tensor):
        (z,) = sum_over(model_group, _z_eff(cell, norm, w_block))
        d2c = cell.weights * loss.d2(z + cell.offsets, cell.labels)

        def hvp(d_block: Tensor) -> Tensor:
            (zd,) = sum_over(model_group, _z_eff(cell, norm, d_block))
            c = d2c * zd
            prefactor, h = sum_over(
                data_group, torch.sum(c, dim=-1), cell.g_pass(c), scalars=1
            )
            h = norm.unshift_gradient(h, prefactor)
            return h + per_member(l2, d_block) * d_block

        return hvp

    return factory


def block_local_hdiag(
    loss, cell, data_group, model_group, l2, norm: NormalizationContext,
) -> Callable[[Tensor], Tensor]:
    """The block of diag(H) at a coefficient block (the reference's
    ``tiled_block_local_hdiag`` / ``_sparse_block_hdiag``): the g-pass over
    squared values summed over the data group, with S1 and S0 for a
    shift (DistributedOptimizationProblem.scala:79-93)."""

    def hdiag(w_block: Tensor) -> Tensor:
        (z,) = sum_over(model_group, _z_eff(cell, norm, w_block))
        c = cell.weights * loss.d2(z + cell.offsets, cell.labels)
        if norm.shift is not None:
            s0, s1, s2 = sum_over(
                data_group, torch.sum(c, dim=-1)[..., None], cell.g_pass(c),
                cell.g_sq_pass(c),
            )
            diag = s2 - 2.0 * norm.shift * s1 + norm.shift**2 * s0
        else:
            (diag,) = sum_over(data_group, cell.g_sq_pass(c))
        if norm.factor is not None:
            diag = diag * norm.factor**2
        return diag + per_member(l2, w_block)

    return hdiag


# ---------------------------------------------------------------------------
# Fit builders
# ---------------------------------------------------------------------------


def _own_block(mesh: ProcessMesh, cell, data_axis=DATA_AXIS, model_axis=MODEL_AXIS) -> slice:
    """This rank's slots of the full vector; the cell must be this rank's."""
    d, m = mesh.index(data_axis), mesh.index(model_axis)
    if (cell.data_index, cell.model_index) != (d, m):
        raise ValueError(
            f"cell ({cell.data_index}, {cell.model_index}) given to the rank "
            f"at ({d}, {m})"
        )
    b = cell.block_dim
    return slice(m * b, (m + 1) * b)


def _unpack_extras(extras, own: slice, *, owlqn: bool, with_norm: bool, with_box: bool):
    """The reference's positional extras (full ``[d_pad]`` vectors) -> this
    rank's (l1, l1_mask, norm, box), vectors cut to its block."""
    extras = list(extras)
    l1 = l1_mask = box = None
    if owlqn:
        l1, l1_mask = extras.pop(0), extras.pop(0)[own]
    norm = NormalizationContext()
    if with_norm:
        shift, factor = extras.pop(0), extras.pop(0)
        norm = NormalizationContext(factor=factor[own], shift=shift[own])
    if with_box:
        lower, upper = extras.pop(0), extras.pop(0)
        box = BoxConstraints(lower[own], upper[own])
    if extras:
        raise ValueError(f"{len(extras)} unexpected extra arguments")
    return l1, l1_mask, norm, box


def _groups(mesh: ProcessMesh, data_axis=DATA_AXIS, model_axis=MODEL_AXIS):
    if data_axis not in mesh.axis_names or model_axis not in mesh.axis_names:
        raise ValueError(
            f"feature-sharded fits need a (data, model) mesh, got axes "
            f"{mesh.axis_names}"
        )
    return mesh.groups[data_axis], mesh.groups[model_axis]


def feature_sharded_glm_fit(
    objective,
    mesh: ProcessMesh,
    *,
    optimizer: str = "lbfgs",  # "lbfgs" | "owlqn" | "tron"
    data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
    max_iter: int = 50,
    tol: float = 1e-7,
    history: int = 10,
    max_cg: int = 20,
    with_norm: bool = False,
    with_box: bool = False,
    track_models: bool = False,
) -> Callable[..., OptResult]:
    """``fit(w0, cell, l2, *extras) -> OptResult`` on this rank of a (data,
    model) mesh; call it on every rank with the same arguments and its own
    cell (``feature_shard_tiled_batch`` or
    :func:`feature_shard_sparse_batch`).

    ``w0`` is the full ``[d_pad]`` vector, or a ``[G, d_pad]`` bank (the
    batched λ-grid, the reference's ``grid=True``: ``l2`` and owlqn's
    ``l1`` are then ``[G]``, and the tiled cell's passes run K2). Extras, in
    order, as the reference's: ``l1, l1_mask`` (owlqn), ``shift, factor``
    (``with_norm``), ``lower, upper`` (``with_box``), vectors full
    ``[d_pad]``. The result's coefficients are the full vector (or bank),
    gathered over the model group: identical on every rank, as the
    reference's global output. ``data_axis`` / ``model_axis`` name the
    mesh's axes. ``track_models``: each rank's optimizer
    tracks its own block of every iterate (``[cap, block_dim]``, no
    collective per trip), and the fit gathers the blocks over the model
    group once, at its end, into the result's ``tracker.coefs``."""
    if optimizer not in ("lbfgs", "owlqn", "tron"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    loss = objective.loss
    data_group, model_group = _groups(mesh, data_axis, model_axis)
    reductions = MeshReductions(model=model_group, world=mesh.world)

    def fit(w0: Tensor, cell, l2, *extras) -> OptResult:
        own = _own_block(mesh, cell, data_axis, model_axis)
        l1, l1_mask, norm, box = _unpack_extras(
            extras, own, owlqn=optimizer == "owlqn", with_norm=with_norm,
            with_box=with_box,
        )
        w0_block = w0[..., own].contiguous()
        vg = block_local_vg(loss, cell, data_group, model_group, l2, norm)
        if optimizer == "tron":
            result = minimize_tron(
                vg, None, w0_block, max_iter=max_iter, tol=tol, max_cg=max_cg,
                box=box, mesh=reductions, track_coefficients=track_models,
                hvp_factory=block_local_hvp_factory(
                    loss, cell, data_group, model_group, l2, norm
                ),
            )
        elif optimizer == "owlqn":
            result = minimize_owlqn(
                vg, w0_block, l1, max_iter=max_iter, tol=tol, history=history,
                l1_mask=l1_mask, box=box, mesh=reductions,
                track_coefficients=track_models,
            )
        else:
            result = minimize_lbfgs(
                vg, w0_block, max_iter=max_iter, tol=tol, history=history,
                box=box, mesh=reductions, track_coefficients=track_models,
            )
        tracker = result.tracker
        if tracker.coefs is not None:
            tracker = dataclasses.replace(
                tracker, coefs=all_gather_last(tracker.coefs, model_group)
            )
        return dataclasses.replace(
            result, coefficients=all_gather_last(result.coefficients, model_group),
            tracker=tracker,
        )

    return fit


def feature_sharded_hessian_diagonal(
    objective, mesh: ProcessMesh, *, with_norm: bool = False,
) -> Callable[..., Tensor]:
    """``hdiag(w, cell, l2[, shift, factor]) -> diag(H)`` as the full
    ``[d_pad]`` vector (or ``[G, d_pad]`` bank), gathered over the model
    group: the variances' pass on the feature-sharded layouts."""
    loss = objective.loss
    data_group, model_group = _groups(mesh)

    def hdiag(w: Tensor, cell, l2, *extras) -> Tensor:
        own = _own_block(mesh, cell)
        _, _, norm, _ = _unpack_extras(
            extras, own, owlqn=False, with_norm=with_norm, with_box=False
        )
        diag = block_local_hdiag(loss, cell, data_group, model_group, l2, norm)(
            w[..., own].contiguous()
        )
        return all_gather_last(diag, model_group)

    return hdiag


def feature_sharded_extras(
    dim: int,
    d_pad: int,
    *,
    normalization: Optional[NormalizationContext] = None,
    box: Optional[BoxConstraints] = None,
    use_owlqn: bool = False,
    intercept_index: Optional[int] = None,
    device: DeviceLike = None,
):
    """The fit's positional extras in one place, as the reference's: ->
    ``(extras_tail, l1_mask, with_norm)``. ``extras_tail`` is ``[shift,
    factor]`` when normalization is active, then ``[lower, upper]`` with a
    box, each padded to ``[d_pad]`` with inert fills (shift 0, factor 1,
    an unbounded box); ``l1_mask`` exempts the intercept (owlqn only)."""
    dev = resolve_device(device)
    with_norm = normalization is not None and not normalization.is_identity

    def pad(v, fill):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return torch.nn.functional.pad(v, (0, d_pad - v.shape[0]), value=fill)

    extras_tail = []
    if with_norm:
        shift, factor = normalization.shift, normalization.factor
        extras_tail += [
            pad(torch.zeros(dim) if shift is None else shift, 0.0),
            pad(torch.ones(dim) if factor is None else factor, 1.0),
        ]
    if box is not None:
        extras_tail += [pad(box.lower, -float("inf")), pad(box.upper, float("inf"))]
    l1_mask = None
    if use_owlqn:
        l1_mask = torch.ones(d_pad, device=dev)
        if intercept_index is not None:
            l1_mask[intercept_index] = 0.0
    return extras_tail, l1_mask, with_norm


# ---------------------------------------------------------------------------
# The reference's public entry points, per rank
# ---------------------------------------------------------------------------
#
# Each returns the function the reference's returns, called on every rank
# of the mesh with the same arguments: the whole batch (each rank cuts its
# own shard) or, on the feature-sharded sparse and tiled layouts, this
# rank's cell. Results are the reference's global outputs, the same on
# every rank.


def _data_parallel(objective, mesh: ProcessMesh, data_axis: str):
    """-> (the objective summing its partials over the data group, the
    batch -> this rank's shard)."""
    from photon_ml_tpu_torch.ops.tiled_sparse import TiledGLMObjective, ensure_tiled_sharded
    from photon_ml_tpu_torch.parallel.mesh import ensure_data_sharded

    obj = dataclasses.replace(objective, group=mesh.groups[data_axis])
    if isinstance(objective, TiledGLMObjective):
        return obj, lambda batch: ensure_tiled_sharded(batch, obj.dim, mesh, data_axis)
    return obj, lambda batch: ensure_data_sharded(batch, mesh, data_axis)


def data_parallel_value_and_grad(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
) -> Callable:
    """``vg(w, batch, l2) -> (value, grad)``: the batch's rows sharded over
    ``data_axis`` (this rank's shard cut here, idempotently), the
    coefficients replicated, one sum of the partials over the data group
    an evaluation (the reference's treeAggregate)."""
    obj, shard = _data_parallel(objective, mesh, data_axis)

    def vg(w: Tensor, batch, l2):
        return obj.value_and_gradient(w, shard(batch), l2)

    return vg


def data_parallel_fit_lbfgs(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
    max_iter: int = 100, tol: float = 1e-7, history: int = 10,
) -> Callable[..., OptResult]:
    """``fit(w0, batch, l2) -> OptResult``: L-BFGS over the data-parallel
    objective of :func:`data_parallel_value_and_grad`; every rank follows
    world rank 0's control flags and returns the same result."""
    obj, shard = _data_parallel(objective, mesh, data_axis)
    reductions = MeshReductions(model=None, world=mesh.world)

    def fit(w0: Tensor, batch, l2) -> OptResult:
        part = shard(batch)
        return minimize_lbfgs(
            lambda w: obj.value_and_gradient(w, part, l2), w0,
            max_iter=max_iter, tol=tol, history=history, mesh=reductions,
        )

    return fit


def _rank_order_sums(group, *parts: Tensor, scalars: int = 0) -> List[Tensor]:
    """Each part summed over ``group`` in rank order
    (``multihost.sum_in_rank_order``, one gather for all of them), so the
    bits repeat from run to run; as they are on a one-rank axis."""
    if group is None:
        return list(parts)
    cols = [p[..., None] for p in parts[:scalars]] + list(parts[scalars:])
    flat = sum_in_rank_order(torch.cat(cols, dim=-1), group)
    out = flat.split([c.shape[-1] for c in cols], dim=-1)
    return [o[..., 0] for o in out[:scalars]] + list(out[scalars:])


def _dense_cell(mesh: ProcessMesh, features, labels, offsets, weights, data_axis, model_axis):
    """The whole dense arrays -> (this rank's ``[n_loc, d / M]`` block, its
    rows' DenseBatch, its slots of the full vector)."""
    from photon_ml_tpu_torch.data.batch import DenseBatch
    from photon_ml_tpu_torch.parallel.mesh import ensure_data_sharded

    shards = mesh.size(model_axis)
    d = features.shape[1]
    if d % shards:
        raise ValueError(
            f"{d} features do not divide the {shards} shards of the "
            f"{model_axis!r} axis"
        )
    rows = ensure_data_sharded(DenseBatch(features, labels, offsets, weights), mesh, data_axis)
    b, m = d // shards, mesh.index(model_axis)
    own = slice(m * b, (m + 1) * b)
    return rows.features[:, own].contiguous(), rows, own


def _dense_block_vg(loss, x_block, rows, l2, data_group, model_group):
    """(value, block gradient) of a coefficient block over a dense cell:
    partial margins ``x_block @ w_block`` summed over the model group, the
    block's gradient ``x_block^T c`` over the data group."""

    def vg(w_block: Tensor):
        w_sq, z = _rank_order_sums(
            model_group, torch.dot(w_block, w_block), torch.matmul(x_block, w_block),
            scalars=1,
        )
        z = z + rows.offsets
        c = rows.weights * loss.d1(z, rows.labels)
        value, grad = _rank_order_sums(
            data_group, torch.sum(rows.weights * loss.value(z, rows.labels)),
            torch.matmul(x_block.T, c), scalars=1,
        )
        return value + 0.5 * l2 * w_sq, grad + l2 * w_block

    return vg


def feature_sharded_value_and_grad(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
) -> Callable:
    """``vg(w, features, labels, offsets, weights, l2) -> (value, grad)``
    over DENSE feature blocks: rank (d, m) holds rows of data shard d and
    columns of block m (the feature count must divide the model axis);
    ``w`` and the returned gradient are the full vectors."""
    loss = objective.loss
    data_group, model_group = _groups(mesh, data_axis, model_axis)

    def vg(w: Tensor, features, labels, offsets, weights, l2):
        x_block, rows, own = _dense_cell(
            mesh, features, labels, offsets, weights, data_axis, model_axis
        )
        value, grad = _dense_block_vg(loss, x_block, rows, l2, data_group, model_group)(
            w[own].contiguous()
        )
        return value, all_gather_last(grad, model_group)

    return vg


def feature_sharded_fit(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS, max_iter: int = 50, tol: float = 1e-7,
    history: int = 10,
) -> Callable[..., OptResult]:
    """``fit(w0, features, labels, offsets, weights, l2) -> OptResult``:
    L-BFGS over a coefficient vector sharded over the model axis, on the
    dense layout of :func:`feature_sharded_value_and_grad`. Each rank keeps
    its block's optimizer state; the result's coefficients are the full
    vector, the same on every rank."""
    loss = objective.loss
    data_group, model_group = _groups(mesh, data_axis, model_axis)
    reductions = MeshReductions(model=model_group, world=mesh.world)

    def fit(w0: Tensor, features, labels, offsets, weights, l2) -> OptResult:
        x_block, rows, own = _dense_cell(
            mesh, features, labels, offsets, weights, data_axis, model_axis
        )
        result = minimize_lbfgs(
            _dense_block_vg(loss, x_block, rows, l2, data_group, model_group),
            w0[own].contiguous(), max_iter=max_iter, tol=tol, history=history,
            mesh=reductions,
        )
        return dataclasses.replace(
            result, coefficients=all_gather_last(result.coefficients, model_group)
        )

    return fit


def feature_sharded_sparse_value_and_grad(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
) -> Callable:
    """``vg(w, cell, l2) -> (value, grad)`` over this rank's cell of the
    sparse layout (:func:`feature_shard_sparse_batch`; a tiled cell runs
    K1): ``w`` and the gradient are the full vectors."""
    data_group, model_group = _groups(mesh, data_axis, model_axis)

    def vg(w: Tensor, cell, l2):
        own = _own_block(mesh, cell, data_axis, model_axis)
        value, grad = block_local_vg(
            objective.loss, cell, data_group, model_group, l2, NormalizationContext()
        )(w[..., own].contiguous())
        return value, all_gather_last(grad, model_group)

    return vg


def feature_sharded_sparse_hessian_vector(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
) -> Callable[..., Tensor]:
    """``hv(w, d, cell, l2) -> H(w) d`` as the full vector, over this rank's
    cell (the streamed feature-sharded TRON's per-chunk building block)."""
    data_group, model_group = _groups(mesh, data_axis, model_axis)

    def hv(w: Tensor, d: Tensor, cell, l2) -> Tensor:
        own = _own_block(mesh, cell, data_axis, model_axis)
        factory = block_local_hvp_factory(
            objective.loss, cell, data_group, model_group, l2, NormalizationContext()
        )
        return all_gather_last(
            factory(w[..., own].contiguous())(d[..., own].contiguous()), model_group
        )

    return hv


def feature_sharded_sparse_fit(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS, max_iter: int = 50, tol: float = 1e-7,
    history: int = 10,
) -> Callable[..., OptResult]:
    """L-BFGS, ``fit(w0, cell, l2)``: :func:`feature_sharded_glm_fit` with
    the reference's defaults for this entry point."""
    return feature_sharded_glm_fit(
        objective, mesh, optimizer="lbfgs", data_axis=data_axis,
        model_axis=model_axis, max_iter=max_iter, tol=tol, history=history,
    )


def feature_sharded_sparse_fit_tron(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS, max_iter: int = 15, tol: float = 1e-5,
    max_cg: int = 20,
) -> Callable[..., OptResult]:
    """TRON, ``fit(w0, cell, l2)``: :func:`feature_sharded_glm_fit` with the
    reference's defaults for this entry point (L2 or none)."""
    return feature_sharded_glm_fit(
        objective, mesh, optimizer="tron", data_axis=data_axis,
        model_axis=model_axis, max_iter=max_iter, tol=tol, max_cg=max_cg,
    )


def feature_sharded_sparse_fit_owlqn(
    objective, mesh: ProcessMesh, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS, max_iter: int = 50, tol: float = 1e-7,
    history: int = 10,
) -> Callable[..., OptResult]:
    """OWL-QN, ``fit(w0, cell, l2, l1, l1_mask)`` (``l1_mask`` the full
    ``[d_pad]`` 0/1 vector): :func:`feature_sharded_glm_fit` with the
    reference's defaults for this entry point."""
    return feature_sharded_glm_fit(
        objective, mesh, optimizer="owlqn", data_axis=data_axis,
        model_axis=model_axis, max_iter=max_iter, tol=tol, history=history,
    )


def _checked_tiled_fit(fit, meta):
    """``fit`` refusing a cell of another layout than ``meta``."""

    def checked(w0: Tensor, cell, l2, *extras) -> OptResult:
        if cell.meta != meta:
            raise ValueError("the cell's layout is not the one the fit was built for")
        return fit(w0, cell, l2, *extras)

    return checked


def feature_sharded_tiled_fit(
    objective, mesh: ProcessMesh, meta, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS, max_iter: int = 50, tol: float = 1e-7,
    history: int = 10, owlqn: bool = False,
) -> Callable[..., OptResult]:
    """L-BFGS (or OWL-QN with ``owlqn``), ``fit(w0, cell, l2[, l1,
    l1_mask])`` over this rank's cell of the tiled layout
    (``feature_shard_tiled_batch``, whose ``meta`` is given): K1 on the
    cell. :func:`feature_sharded_glm_fit` with the reference's defaults."""
    return _checked_tiled_fit(feature_sharded_glm_fit(
        objective, mesh, optimizer="owlqn" if owlqn else "lbfgs",
        data_axis=data_axis, model_axis=model_axis, max_iter=max_iter, tol=tol,
        history=history,
    ), meta)


def feature_sharded_tiled_fit_tron(
    objective, mesh: ProcessMesh, meta, *, data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS, max_iter: int = 15, tol: float = 1e-5,
    max_cg: int = 20,
) -> Callable[..., OptResult]:
    """TRON, ``fit(w0, cell, l2)`` over this rank's tiled cell (K1 on every
    z- and g-pass of each CG step): :func:`feature_sharded_glm_fit` with
    the reference's defaults."""
    return _checked_tiled_fit(feature_sharded_glm_fit(
        objective, mesh, optimizer="tron", data_axis=data_axis,
        model_axis=model_axis, max_iter=max_iter, tol=tol, max_cg=max_cg,
    ), meta)
