"""Rank functions of the port's library-surface tests
(``tests/test_torch_cache_roles.py``, ``tests/test_torch_public_fits.py``).
Imports neither JAX nor the reference: a spawned rank re-imports this
module."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch.convert import feature_sharded_cell_from_reference
from photon_ml_tpu_torch.data.batch import SparseBatch, make_sparse_batch
from photon_ml_tpu_torch.ops import schedule_cache
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.ops.tiled_sparse import (
    TileParams,
    TiledGLMObjective,
    feature_shard_tiled_batch,
    tiled_batch_from_sparse,
    tiled_g_pass,
    tiled_z_pass,
)
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.parallel import distributed as dist_fits
from photon_ml_tpu_torch.parallel.distributed import feature_shard_sparse_batch
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from photon_ml_tpu_torch.task import TaskType

CACHE_PARAMS = dict(s_hi=8, s_lo=8, chunk=32, spill_cap=8)


def schedule_arrays(tb):
    return [
        t for sched in (tb.z_sched, tb.g_sched)
        for t in (sched.step_out, sched.step_in, sched.step_init, sched.out_pos,
                  sched.in_pos, sched.vals, sched.spill_out, sched.spill_in,
                  sched.spill_vals)
    ]


def _passes(tb, seed):
    """K1's z- and g-passes (their plain versions on the CPU) over ``tb``."""
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32))
    return tiled_z_pass(tb, w), tiled_g_pass(tb, c)


def _tile(build, cache_dir):
    """One cold and one warm conversion under ``cache_dir`` -> each one's
    cache counters and schedules, and the warm one's passes."""
    out = []
    for _ in range(2):
        schedule_cache.reset_stats()
        with schedule_cache.cache_scope(cache_dir):
            tb = build()
        out.append(dict(stats=schedule_cache.stats().as_dict(),
                        arrays=schedule_arrays(tb), builder=tb.builder))
    out[-1]["passes"] = _passes(tb, 7)
    return out


def same_key_rank(mesh, rows, labels, dim, cache_dir):
    """Every process tiles the same whole batch (the same keys): process 0
    stores, the other waits for its artifacts."""
    batch = make_sparse_batch(rows, labels, device="cpu")
    return _tile(lambda: tiled_batch_from_sparse(
        batch, dim, params=TileParams(**CACHE_PARAMS), device="cpu"
    ), cache_dir)


def cell_rank(mesh, rows, labels, dim, cache_dir, replicas):
    """Each rank tiles its (data, model) cell with the mesh's builders of
    it: on the spawned 1 x 2 mesh two cells, each its own rank's key; with
    ``replicas`` every rank is a 1 x 1 mesh of its own, all holding the
    same cell, whose lowest rank writes."""
    if replicas:
        mesh = make_mesh((1, 1), (DATA_AXIS, MODEL_AXIS), device="cpu", replicas=True)
    batch = make_sparse_batch(rows, labels, device="cpu")

    def build():
        cell, _ = feature_shard_tiled_batch(
            batch, dim, mesh.size(DATA_AXIS), mesh.size(MODEL_AXIS),
            mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS),
            params=TileParams(**CACHE_PARAMS), device="cpu",
            builders=mesh.ranks_sharing((DATA_AXIS, MODEL_AXIS)),
        )
        return cell.cell

    return dict(builders=mesh.ranks_sharing((DATA_AXIS, MODEL_AXIS)), runs=_tile(build, cache_dir))


# ---------------------------------------------------------------------------
# The public fit entry points
# ---------------------------------------------------------------------------


def _result(res):
    return dict(coefficients=res.coefficients, value=float(res.value),
                iterations=int(res.iterations), reason=int(res.reason))


def _bitwise(a, b) -> bool:
    return torch.equal(a.coefficients, b.coefficients) and all(
        torch.equal(torch.as_tensor(getattr(a, f)), torch.as_tensor(getattr(b, f)))
        for f in ("value", "grad_norm", "iterations", "reason")
    )


def sparse_entry_rank(mesh, rows, labels, weights, dim, l2, l1, tol, tron_tol):
    """The sparse layout's entry points on this rank's cell, each against
    ``feature_sharded_glm_fit`` with the same settings on the same cell."""
    batch = make_sparse_batch(rows, labels, weights=weights, device="cpu")
    cell, block_dim = feature_shard_sparse_batch(
        batch, dim, mesh.size(DATA_AXIS), mesh.size(MODEL_AXIS),
        mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS), device="cpu",
    )
    obj = GLMObjective(LOGISTIC, dim)
    d_pad = mesh.size(MODEL_AXIS) * block_dim
    w0 = torch.zeros(d_pad)
    l1_mask = torch.ones(d_pad)
    l1_mask[dim - 1] = 0.0
    rng = np.random.default_rng(3)
    w = torch.as_tensor((rng.normal(size=d_pad) * 0.1).astype(np.float32))
    d = torch.as_tensor(rng.normal(size=d_pad).astype(np.float32))
    out = {}
    for name, public, general, extras in (
        ("lbfgs", dist_fits.feature_sharded_sparse_fit(obj, mesh, tol=tol),
         dist_fits.feature_sharded_glm_fit(obj, mesh, tol=tol), ()),
        ("tron", dist_fits.feature_sharded_sparse_fit_tron(obj, mesh, tol=tron_tol),
         dist_fits.feature_sharded_glm_fit(obj, mesh, optimizer="tron", max_iter=15,
                                           tol=tron_tol), ()),
        ("owlqn", dist_fits.feature_sharded_sparse_fit_owlqn(obj, mesh, tol=tol),
         dist_fits.feature_sharded_glm_fit(obj, mesh, optimizer="owlqn", tol=tol),
         (torch.tensor(l1), l1_mask)),
    ):
        a = public(w0, cell, torch.tensor(l2), *extras)
        b = general(w0, cell, torch.tensor(l2), *extras)
        out[name] = dict(_result(a), same_as_general=_bitwise(a, b))
    value, grad = dist_fits.feature_sharded_sparse_value_and_grad(obj, mesh)(
        w, cell, torch.tensor(l2))
    hv = dist_fits.feature_sharded_sparse_hessian_vector(obj, mesh)(
        w, d, cell, torch.tensor(l2))
    out["vg"] = dict(value=float(value), grad=grad, hv=hv, w=w, d=d)
    return out


def tiled_entry_rank(mesh, layout, dim, l2, tol, tron_tol):
    """``feature_sharded_tiled_fit`` and ``_tron`` on this rank's cell of the
    reference's tiled layout (K1, its plain version on the CPU), each
    against ``feature_sharded_glm_fit``; a cell of another layout is
    refused."""
    cell = feature_sharded_cell_from_reference(
        *layout, data_index=mesh.index(DATA_AXIS), model_index=mesh.index(MODEL_AXIS),
        device="cpu",
    )
    obj = TiledGLMObjective(LOGISTIC, dim)
    w0 = torch.zeros(mesh.size(MODEL_AXIS) * cell.block_dim)
    out = {}
    for name, public, general in (
        ("lbfgs", dist_fits.feature_sharded_tiled_fit(obj, mesh, cell.meta, tol=tol),
         dist_fits.feature_sharded_glm_fit(obj, mesh, tol=tol)),
        ("tron", dist_fits.feature_sharded_tiled_fit_tron(obj, mesh, cell.meta, tol=tron_tol),
         dist_fits.feature_sharded_glm_fit(obj, mesh, optimizer="tron", max_iter=15,
                                           tol=tron_tol)),
    ):
        a = public(w0, cell, torch.tensor(l2))
        b = general(w0, cell, torch.tensor(l2))
        out[name] = dict(_result(a), same_as_general=_bitwise(a, b))
    other = dist_fits.feature_sharded_tiled_fit(
        obj, mesh, dataclasses.replace(cell.meta, real_dim=dim + 1))
    try:
        other(w0, cell, torch.tensor(l2))
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


def dense_entry_rank(mesh, features, labels, offsets, weights, l2, tol, max_iter):
    """The dense ``feature_sharded_value_and_grad`` and ``feature_sharded_fit``
    over the whole arrays (each rank cuts its cell), twice each."""
    obj = GLMObjective(LOGISTIC, features.shape[1])
    f, lab, off, wgt = (torch.as_tensor(a) for a in (features, labels, offsets, weights))
    w = torch.as_tensor(np.linspace(-0.2, 0.2, features.shape[1]), dtype=f.dtype)
    vg = dist_fits.feature_sharded_value_and_grad(obj, mesh)
    value, grad = vg(w, f, lab, off, wgt, l2)
    fit = dist_fits.feature_sharded_fit(obj, mesh, tol=tol, max_iter=max_iter)
    runs = [fit(torch.zeros_like(w), f, lab, off, wgt, l2) for _ in range(2)]
    return dict(value=float(value), grad=grad, fit=_result(runs[0]),
                repeat=_bitwise(runs[0], runs[1]))


def data_parallel_rank(mesh, arrays, dim, l2, tol):
    """``data_parallel_value_and_grad`` and ``data_parallel_fit_lbfgs`` over
    the whole batch (the reference's padded arrays; each rank cuts its
    rows); in float32 the fit against ``GLMOptimizationProblem.run`` on
    this rank's shard, and the tiled objective's fit (its shard through
    ``ensure_tiled_sharded``)."""
    from photon_ml_tpu_torch.parallel.mesh import ensure_data_sharded

    batch = SparseBatch(*(torch.as_tensor(a) for a in arrays))
    obj = GLMObjective(LOGISTIC, dim)
    w = torch.as_tensor(np.linspace(-0.3, 0.3, dim), dtype=batch.values.dtype)
    value, grad = dist_fits.data_parallel_value_and_grad(obj, mesh)(w, batch, l2)
    fit = dist_fits.data_parallel_fit_lbfgs(obj, mesh, tol=tol)
    res = fit(torch.zeros_like(w), batch, l2)
    out = dict(value=float(value), grad=grad, fit=_result(res))
    if batch.values.dtype == torch.float32:
        problem = GLMOptimizationProblem(
            TaskType.LOGISTIC_REGRESSION, obj, config=OptimizerConfig(tolerance=tol),
            regularization=RegularizationContext(RegularizationType.L2),
        )
        _, ref = problem.run(ensure_data_sharded(batch, mesh), reg_weight=l2, mesh=mesh)
        out["same_as_problem"] = _bitwise(res, ref)
        tiled = dist_fits.data_parallel_fit_lbfgs(TiledGLMObjective(LOGISTIC, dim), mesh, tol=tol)
        out["tiled"] = _result(tiled(torch.zeros_like(w), batch, l2))
    return out
