"""GLM training over a λ-grid (port of ``photon_ml_tpu/training.py``):

- ``train_generalized_linear_model``: one fit per λ, warm-started.
  Reference: photon-ml ModelTraining.scala:103-215: one problem per task,
  regularization weights sorted DESCENDING (:172), each lambda
  warm-started from the previous one's coefficients (:183-208).
- ``train_grid_batched``: the whole grid as one bank ``[G, d]`` of cold
  starts, every data pass shared by all members (K2 on the card), and
  ``resolve_grid_mode``, the policy that picks between the two.
- ``mesh=`` on both: the data-parallel fit over the ranks of a mesh (each
  rank tiles or keeps only its shard of the rows).
- ``train_feature_sharded`` and ``train_grid_batched_feature_sharded``:
  the same two over a coefficient vector sharded by feature block on a
  (data, model) mesh (``parallel/distributed.py``).
- ``train_streaming_glm``: the out-of-core fit over input files larger
  than host RAM (``io/streaming.py``), warm-started over the λ-grid with
  the host-driven optimizers.
- ``grid_checkpointer=``: per-λ crash-safe snapshots
  (``reliability.GridCheckpointer``, written once, by process 0) on the
  sequential and batched trainers, on a data mesh too, and on both
  streamed trainers; ``preemption_guard=``: a stop at the λ boundary on
  SIGTERM, agreed by every rank, on the sequential and both streamed
  trainers. The in-memory feature-sharded trainers take neither.
- ``resolve_entity_shards``: the GAME driver's ``--entity-shards``.

On a mesh every rank calls the trainer with the same arguments (the whole
batch) and gets the same models.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.obs.trace import span as obs_span
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.ops.schedule_cache import cache_scope
from photon_ml_tpu_torch.ops.tiled_sparse import (
    TiledSparseBatch,
    build_sharded_tiled_batch,
    feature_shard_tiled_batch,
    tiled_batch_from_sparse,
)
from photon_ml_tpu_torch.optim.common import BoxConstraints, OptResult, Tracker, fetch
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.factory import validate_optimizer_choice
from photon_ml_tpu_torch.optim.problem import (
    _VARIANCE_EPSILON,
    GLMOptimizationProblem,
    create_glm_problem,
    resolve_kernel,
)
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.distributed import (
    feature_shard_sparse_batch,
    feature_sharded_extras,
    feature_sharded_glm_fit,
    feature_sharded_hessian_diagonal,
)
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ProcessMesh,
    data_shard_sparse_batch,
)
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


Models = Dict[float, GeneralizedLinearModel]
Results = Dict[float, OptResult]


def _fit_device(device: DeviceLike, mesh: Optional[ProcessMesh]) -> torch.device:
    """Where a fit runs: ``device``, or on a mesh the mesh's device."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        raise ValueError("on a mesh the fit runs on mesh.device; pass no device")
    return mesh.device


def _problem_on_device(
    batch, task, dim, *, optimizer_type, regularization_type,
    elastic_net_alpha, max_iter, tolerance, normalization, compute_variances,
    box, intercept_index, kernel, device, mesh, tile_cache_dir=None,
) -> Tuple[GLMOptimizationProblem, object, Optional[NormalizationContext]]:
    """The problem both trainers solve, with the batch (tiled for the
    tiled kernel, through the schedule cache at ``tile_cache_dir`` when one
    is given; on a mesh, this rank's shard of it) and the other tensors
    moved to the fit's device."""
    dev = _fit_device(device, mesh)
    base = OptimizerConfig.default_for(optimizer_type)
    config = OptimizerConfig(
        optimizer_type=optimizer_type,
        max_iter=max_iter if max_iter is not None else base.max_iter,
        tolerance=tolerance if tolerance is not None else base.tolerance,
        lbfgs_history=base.lbfgs_history,
        tron_max_cg=base.tron_max_cg,
    )
    regularization = RegularizationContext(regularization_type, elastic_net_alpha)
    kernel = resolve_kernel(kernel, dev)
    shard = None if mesh is None else (mesh.size(DATA_AXIS), mesh.index(DATA_AXIS))
    if kernel == "tiled":
        if isinstance(batch, SparseBatch):
            with cache_scope(tile_cache_dir):
                batch = (
                    tiled_batch_from_sparse(batch, dim, device=dev) if shard is None
                    else build_sharded_tiled_batch(
                        batch, dim, *shard, device=dev,
                        builders=mesh.ranks_sharing((DATA_AXIS,)),
                    )
                )
        elif not isinstance(batch, TiledSparseBatch):
            raise TypeError(
                "kernel='tiled' requires a SparseBatch or TiledSparseBatch, "
                f"got {type(batch).__name__}"
            )
    elif not isinstance(batch, SparseBatch):
        raise TypeError(
            f"kernel='scatter' requires a SparseBatch, got {type(batch).__name__}"
        )
    elif shard is not None:
        batch = data_shard_sparse_batch(batch, *shard)
    batch = batch.to(dev)
    if normalization is not None:
        normalization = normalization.to(dev)
    if box is not None:
        box = BoxConstraints(box.lower.to(dev), box.upper.to(dev))
    problem = create_glm_problem(
        task, dim, config=config, regularization=regularization,
        norm=normalization, compute_variances=compute_variances, box=box,
        intercept_index=intercept_index, kernel=kernel,
    )
    return problem, batch, normalization


def _descending(regularization_weights: Sequence[float]) -> List[float]:
    """Strongest regularization first (ModelTraining.scala:172)."""
    return sorted(set(float(w) for w in regularization_weights), reverse=True)


# -- λ-grid crash-safe snapshots (reliability.GridCheckpointer) ---------------
#
# One snapshot per completed λ: the warm-start means (the optimization
# space's coefficients, which the next λ's solve starts from, so a resumed
# sweep walks bitwise the same iterate chain), the exported model (original
# space) and the OptResult arrays, under the JAX package's npz keys and
# dtypes, so a snapshot loads in either package. A kill -9 in the middle of
# a λ loses only that λ's solve.


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _snapshot_result_arrays(result: OptResult) -> Dict[str, np.ndarray]:
    t = result.tracker
    arrs = {
        "coefficients": _host(result.coefficients),
        "value": _host(result.value),
        "grad_norm": _host(result.grad_norm),
        "iterations": np.asarray(result.iterations, np.int32),
        "reason": np.asarray(result.reason, np.int32),
        "tracker_values": _host(t.values),
        "tracker_grad_norms": _host(t.grad_norms),
        "tracker_count": np.asarray(t.count, np.int32),
    }
    if t.coefs is not None:
        arrs["tracker_coefs"] = _host(t.coefs)
    return arrs


def _result_from_snapshot(d: Dict[str, np.ndarray], device) -> OptResult:
    def up(a):
        return torch.as_tensor(np.asarray(a), device=device)

    coefs = d.get("tracker_coefs")
    return OptResult(
        coefficients=up(d["coefficients"]),
        value=up(d["value"]),
        grad_norm=up(d["grad_norm"]),
        iterations=int(d["iterations"]),
        reason=int(d["reason"]),
        tracker=Tracker(
            values=up(d["tracker_values"]),
            grad_norms=up(d["tracker_grad_norms"]),
            count=int(d["tracker_count"]),
            coefs=up(coefs) if coefs is not None else None,
        ),
    )


def _model_from_snapshot(task: TaskType, snap, device) -> GeneralizedLinearModel:
    var = snap.get("model_variances")
    return GeneralizedLinearModel(task, Coefficients(
        torch.as_tensor(snap["model_means"], device=device),
        torch.as_tensor(var, device=device) if var is not None else None,
    ))


def _save_lambda_snapshot(checkpointer, lam: float, warm_means, model, result: OptResult) -> None:
    variances = model.coefficients.variances
    checkpointer.save(
        lam,
        warm_means=_host(warm_means),
        model_means=_host(model.means),
        model_variances=_host(variances) if variances is not None else None,
        result_arrays=_snapshot_result_arrays(result),
    )


def _stop_requested(preemption_guard, mesh: Optional[ProcessMesh] = None) -> bool:
    """Whether to stop the sweep at this λ boundary for a preemption:
    agreed by every rank of ``mesh`` (a SIGTERM may reach only some;
    ranks that stopped alone would leave the others waiting in a
    collective), and by every process of a multi-process run."""
    flag = preemption_guard is not None and preemption_guard.requested
    if mesh is not None:
        t = torch.tensor([float(flag)], device=_collective_device(mesh.world, mesh.device))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.world)
        return bool(t.item())
    return multihost.any_process(flag)


def _collective_device(group, device) -> torch.device:
    """Where a small collective's tensor lives for ``group``'s backend."""
    return device if dist.get_backend(group) == "nccl" else torch.device("cpu")


def _maybe_save_snapshot(checkpointer, lam, warm_means, model, result) -> None:
    """A λ snapshot, written once: by process 0 (every rank of a mesh or a
    multi-process run holds the same model)."""
    if checkpointer is not None and multihost.is_coordinator():
        _save_lambda_snapshot(checkpointer, lam, warm_means, model, result)


def train_generalized_linear_model(
    batch: Union[SparseBatch, TiledSparseBatch],
    task: TaskType,
    dim: int,
    *,
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    regularization_type: RegularizationType = RegularizationType.NONE,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: Optional[float] = None,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    normalization: Optional[NormalizationContext] = None,
    warm_start: bool = True,
    compute_variances: bool = False,
    box: Optional[BoxConstraints] = None,
    intercept_index: Optional[int] = None,
    initial: Optional[Tensor] = None,
    kernel: str = "scatter",
    device: DeviceLike = None,
    mesh: Optional[ProcessMesh] = None,
    track_models: bool = False,
    tile_cache_dir: Optional[str] = None,
    grid_checkpointer=None,
    preemption_guard=None,
) -> Tuple[Models, Results]:
    """Train one model per regularization weight with warm starts.

    Returns ({lambda: model}, {lambda: OptResult}); models are in the
    ORIGINAL feature space (normalization undone). L1 and elastic net run
    OWL-QN, with the intercept (``intercept_index``) exempt from the L1
    penalty.

    ``kernel``: "scatter" | "tiled" | "auto" (see
    ``optim.problem.resolve_kernel``). For "tiled" a SparseBatch is tiled
    once here with the default TileParams; pass a TiledSparseBatch to
    choose them. ``device`` (default: the CUDA card) is where the fit runs;
    the batch and the other tensors are moved there.

    ``mesh``: the data-parallel fit on this rank of a mesh with a "data"
    axis (every rank passes the whole SparseBatch; the fit runs on
    ``mesh.device``). A TiledSparseBatch must then be this rank's
    ``build_sharded_tiled_batch``.

    ``track_models``: keep every iterate in each OptResult's
    ``tracker.coefs`` (the ModelTracker analog, written on the device with
    no host fetch); :func:`iteration_models` turns a result into
    per-iteration models in the original feature space.

    ``tile_cache_dir``: the persistent schedule cache
    (``ops/schedule_cache.py``) for tiling a SparseBatch here: a rerun over
    the same data loads the schedules instead of building them. None
    leaves an outer scope or ``PHOTON_TILE_CACHE_DIR`` in force.

    ``grid_checkpointer`` (``reliability.GridCheckpointer``): per-λ
    crash-safe snapshots. A completed λ loads instead of being solved
    again, and the next λ warm-starts from the snapshotted means, so the
    final models are bitwise what an uninterrupted run gives where the
    fits repeat bitwise (on the CPU; K1's float atomics do not repeat).
    ``preemption_guard``: a SIGTERM stops the sweep before the next λ's
    solve (the λ boundary is the safe point); the solved λs are
    snapshotted and returned.
    """
    problem, batch, normalization = _problem_on_device(
        batch, task, dim, optimizer_type=optimizer_type,
        regularization_type=regularization_type,
        elastic_net_alpha=elastic_net_alpha, max_iter=max_iter,
        tolerance=tolerance, normalization=normalization,
        compute_variances=compute_variances, box=box,
        intercept_index=intercept_index, kernel=kernel, device=device,
        mesh=mesh, tile_cache_dir=tile_cache_dir,
    )
    # strongest regularization first, so each warm start relaxes an
    # already-shrunk model
    models: Models = {}
    results: Results = {}
    dev = batch.labels.device
    current = None if initial is None else torch.as_tensor(initial, device=dev)
    for lam in _descending(regularization_weights):
        snap = grid_checkpointer.load(lam) if grid_checkpointer is not None else None
        if snap is not None:
            # solved by an earlier, interrupted run: restore instead of
            # solving again; the snapshotted warm means keep the iterate
            # chain of the λs still to solve bitwise the same
            models[lam] = _model_from_snapshot(task, snap, dev)
            results[lam] = _result_from_snapshot(snap["result"], dev)
            if warm_start:
                current = torch.as_tensor(snap["warm_means"], device=dev)
            continue
        if _stop_requested(preemption_guard, mesh):
            # stop at the λ boundary; a rerun resumes the sweep here
            break
        with obs_span("glm.lambda_solve", reg_weight=lam):
            coefficients, result = problem.run(
                batch, initial=current, reg_weight=lam, mesh=mesh,
                track_models=track_models,
            )
        models[lam] = problem.create_model(coefficients, normalization)
        results[lam] = result
        _maybe_save_snapshot(grid_checkpointer, lam, coefficients.means, models[lam], result)
        if warm_start:
            current = coefficients.means
    return models, results


# Default memory budget for the batched grid's coefficient bank and its
# optimizer state; "auto" falls back to the warm-started sequential path
# above it.
DEFAULT_GRID_MEMORY_BUDGET = 1 << 30


def grid_bank_bytes(
    num_weights: int,
    dim: int,
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    history: int = 10,
    entity_shards: int = 1,
) -> int:
    """Estimated bytes per device of the batched grid's [G, d] bank plus
    each member's optimizer state: L-BFGS's [m, d] s/y buffers dominate;
    TRON carries the CG vectors instead. Under the unified mesh's
    (grid, entity) placement the bank rows split over ``entity_shards``
    ranks, so each holds ~1/N; 1 is the replicated figure."""
    if optimizer_type == OptimizerType.TRON:
        vectors_per_member = 12  # w, g + CG s/r/d/hd + trial w/g + slack
    else:
        vectors_per_member = 2 * history + 8
    total = int(num_weights) * vectors_per_member * int(dim) * 4
    return -(-total // max(1, int(entity_shards)))


def resolve_grid_mode(
    mode: str,
    *,
    num_weights: int,
    dim: int,
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    history: int = 10,
    memory_budget_bytes: int = DEFAULT_GRID_MEMORY_BUDGET,
    streaming: bool = False,
    entity_shards: int = 1,
) -> str:
    """Resolve ``--grid-mode {batched,sequential,auto}`` to a path.
    ``auto`` picks batched when the grid has more than one member, the
    data is in memory (not streaming) and the bank fits the budget
    (:func:`grid_bank_bytes`, per device: ``entity_shards`` splits it);
    else sequential. An explicit ``batched`` with streaming input is a
    configuration error."""
    if mode not in ("batched", "sequential", "auto"):
        raise ValueError(
            f"unknown grid mode {mode!r}; expected batched | sequential | auto"
        )
    if mode == "sequential":
        return "sequential"
    if streaming:
        if mode == "batched":
            raise ValueError(
                "--grid-mode batched is incompatible with streaming input: "
                "the streamed objectives evaluate through host IO, which "
                "the batched optimizers cannot run over; use sequential or auto"
            )
        return "sequential"
    if mode == "batched":
        return "batched"
    if num_weights <= 1:
        return "sequential"
    bank = grid_bank_bytes(num_weights, dim, optimizer_type, history, entity_shards)
    return "batched" if bank <= memory_budget_bytes else "sequential"


def resolve_entity_shards(
    requested: Optional[int],
    *,
    num_devices: Optional[int] = None,
) -> Optional[int]:
    """Resolve the GAME driver's ``--entity-shards`` to an entity-mesh size
    (pod-scale GAME, ``game/pod.py``), or None for the replicated banks.

    ``None`` / ``0`` keeps the replicated default (entity sharding is
    opt-in); ``-1`` means every device, a device being a process here
    (each drives one); an explicit N must fit the device count. N == 1 is
    the single-shard pod path, the parity baseline."""
    if requested is None or requested == 0:
        return None
    n_dev = num_devices if num_devices is not None else multihost.process_count()
    if requested == -1:
        return n_dev
    if not 1 <= requested <= n_dev:
        raise ValueError(
            f"--entity-shards {requested} out of range for {n_dev} "
            "visible devices (use -1 for all devices, 0 to disable)"
        )
    return int(requested)


def train_grid_batched(
    batch: Union[SparseBatch, TiledSparseBatch],
    task: TaskType,
    dim: int,
    *,
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    regularization_type: RegularizationType = RegularizationType.NONE,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: Optional[float] = None,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    normalization: Optional[NormalizationContext] = None,
    compute_variances: bool = False,
    box: Optional[BoxConstraints] = None,
    intercept_index: Optional[int] = None,
    initial: Optional[Tensor] = None,
    kernel: str = "scatter",
    device: DeviceLike = None,
    mesh: Optional[ProcessMesh] = None,
    track_models: bool = False,
    tile_cache_dir: Optional[str] = None,
    grid_checkpointer=None,
) -> Tuple[Models, Results]:
    """Batched twin of :func:`train_generalized_linear_model`: the grid
    stacks into a [G, d] coefficient bank and one run of the optimizer
    solves every λ at once (``GLMOptimizationProblem.run_grid``). Every
    data pass serves the whole bank: on the tiled kernel that is K2, which
    reads the schedule once per pass for all members. Box constraints,
    normalization and offsets broadcast over the members; converged
    members freeze while the others run on.

    There are NO warm starts between members: each λ starts from
    ``initial``. Returns the sequential trainer's ({lambda: model},
    {lambda: OptResult}) contract, λ descending; the values stay on the
    device for :func:`grid_result_scalars`' one fetch. ``kernel``,
    ``device``, ``mesh``, ``track_models`` and ``tile_cache_dir`` as for
    the sequential trainer ("auto" is the tiled kernel on the card).

    ``grid_checkpointer``: the unit of a snapshot is the completed grid
    (one solve has no per-λ boundary inside it), so a rerun after the
    solve loads every λ and solves nothing; else it solves the grid again.
    """
    weights_desc = _descending(regularization_weights)
    dev = _fit_device(device, mesh)
    if grid_checkpointer is not None and all(grid_checkpointer.has(lam) for lam in weights_desc):
        models: Models = {}
        results: Results = {}
        for lam in weights_desc:
            snap = grid_checkpointer.load(lam)
            models[lam] = _model_from_snapshot(task, snap, dev)
            results[lam] = _result_from_snapshot(snap["result"], dev)
        return models, results
    problem, batch, normalization = _problem_on_device(
        batch, task, dim, optimizer_type=optimizer_type,
        regularization_type=regularization_type,
        elastic_net_alpha=elastic_net_alpha, max_iter=max_iter,
        tolerance=tolerance, normalization=normalization,
        compute_variances=compute_variances, box=box,
        intercept_index=intercept_index, kernel=kernel, device=device,
        mesh=mesh, tile_cache_dir=tile_cache_dir,
    )
    with obs_span("glm.grid_solve", grid=len(weights_desc), batched=True):
        variances, result = problem.run_grid(
            batch, weights_desc, initial=initial, mesh=mesh, track_models=track_models
        )
    models = {}
    results = {}
    for i, lam in enumerate(weights_desc):
        var_i = variances[i] if variances is not None else None
        coefficients = Coefficients(result.coefficients[i], var_i)
        models[lam] = problem.create_model(coefficients, normalization)
        results[lam] = result.member(i)
        _maybe_save_snapshot(
            grid_checkpointer, lam, result.coefficients[i], models[lam], results[lam]
        )
    return models, results


@dataclass
class _FeatureShardedProblem:
    """What both feature-sharded trainers share: this rank's cell, the fit
    and Hessian-diagonal builders and the extras protocol."""

    problem: GLMOptimizationProblem  # for create_model
    normalization: Optional[NormalizationContext]
    cell: object
    d_pad: int
    fit: object
    hdiag: object
    extras_tail: list  # [shift, factor] with normalization, then [lower, upper]
    norm_extras: list  # [shift, factor] or []
    l1_mask: Optional[Tensor]

    def solve(self, w0: Tensor, l1, l2) -> Tuple[OptResult, Optional[Tensor]]:
        """One fit ([d_pad] with scalar weights) or a bank ([G, d_pad] with
        [G] weights) -> (result over d_pad, variances over dim or None)."""
        extras = ([l1, self.l1_mask] if self.l1_mask is not None else []) + self.extras_tail
        result = self.fit(w0, self.cell, l2, *extras)
        variances = None
        if self.hdiag is not None:
            hd = self.hdiag(result.coefficients, self.cell, l2, *self.norm_extras)
            variances = (1.0 / (hd + _VARIANCE_EPSILON))[..., : self.problem.objective.dim]
        return result, variances

    def model(self, coef_pad: Tensor, variances: Optional[Tensor]) -> GeneralizedLinearModel:
        """The model in the original feature space (normalization undone)."""
        dim = self.problem.objective.dim
        return self.problem.create_model(
            Coefficients(coef_pad[:dim], variances), self.normalization
        )


def _feature_sharded_problem(
    batch, task, dim, *, mesh, regularization, max_iter, tolerance, history,
    normalization, compute_variances, box, intercept_index, kernel,
    optimizer_type, track_models, tile_cache_dir,
) -> _FeatureShardedProblem:
    if not isinstance(batch, SparseBatch):
        raise TypeError(
            "feature-sharded training requires a SparseBatch, got "
            f"{type(batch).__name__}"
        )
    if MODEL_AXIS not in mesh.axis_names or DATA_AXIS not in mesh.axis_names:
        raise ValueError(
            "feature-sharded training needs a (data, model) mesh, got "
            f"axes {mesh.axis_names}"
        )
    loss = loss_for_task(task)
    validate_optimizer_choice(
        OptimizerConfig(optimizer_type=optimizer_type), regularization,
        loss_has_hessian=loss.has_hessian,
    )
    base = OptimizerConfig.default_for(optimizer_type)
    dev = mesh.device
    kernel = resolve_kernel(kernel, dev)
    args = (batch, dim, mesh.size(DATA_AXIS), mesh.size(MODEL_AXIS),
            mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS))
    # a tiled cell's schedules go through the schedule cache under its own
    # key (its cell's entries), written by the lowest rank holding the cell
    with cache_scope(tile_cache_dir):
        cell, block_dim = (
            feature_shard_tiled_batch(
                *args, device=dev, builders=mesh.ranks_sharing((DATA_AXIS, MODEL_AXIS)),
            ) if kernel == "tiled" else feature_shard_sparse_batch(*args, device=dev)
        )
    d_pad = mesh.size(MODEL_AXIS) * block_dim
    if normalization is not None:
        normalization = normalization.to(dev)
    use_owlqn = regularization.has_l1
    extras_tail, l1_mask, with_norm = feature_sharded_extras(
        dim, d_pad, normalization=normalization,
        box=None if box is None else BoxConstraints(box.lower.to(dev), box.upper.to(dev)),
        use_owlqn=use_owlqn, intercept_index=intercept_index, device=dev,
    )
    objective = GLMObjective(loss, dim)
    fit = feature_sharded_glm_fit(
        objective, mesh,
        optimizer=(
            "tron" if optimizer_type == OptimizerType.TRON
            else "owlqn" if use_owlqn else "lbfgs"
        ),
        max_iter=max_iter if max_iter is not None else base.max_iter,
        tol=tolerance if tolerance is not None else base.tolerance,
        history=history, max_cg=base.tron_max_cg, with_norm=with_norm,
        with_box=box is not None, track_models=track_models,
    )
    hdiag = (
        feature_sharded_hessian_diagonal(objective, mesh, with_norm=with_norm)
        if compute_variances else None
    )
    problem = GLMOptimizationProblem(
        task=task, objective=objective, intercept_index=intercept_index
    )
    return _FeatureShardedProblem(
        problem, normalization, cell, d_pad, fit, hdiag, extras_tail,
        extras_tail[:2] if with_norm else [], l1_mask,
    )


def train_feature_sharded(
    batch: SparseBatch,
    task: TaskType,
    dim: int,
    *,
    mesh: ProcessMesh,
    regularization_type: RegularizationType = RegularizationType.NONE,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: Optional[float] = None,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    history: int = 10,
    warm_start: bool = True,
    normalization: Optional[NormalizationContext] = None,
    compute_variances: bool = False,
    box: Optional[BoxConstraints] = None,
    intercept_index: Optional[int] = None,
    kernel: str = "scatter",
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    track_models: bool = False,
    tile_cache_dir: Optional[str] = None,
) -> Tuple[Models, Results]:
    """λ-grid over a FEATURE-SHARDED coefficient vector on a (data, model)
    mesh, warm-started λ to λ (the reference's ``train_feature_sharded``).

    Every rank calls it with the same arguments and the whole batch, builds
    only its own cell once (``kernel``: "tiled" = K1 on the cell's
    schedules, "scatter" = gather/scatter; "auto" = tiled on the card) and
    gets the same ({lambda: model}, {lambda: OptResult}). L1 and elastic
    net run sharded OWL-QN; L2/none sharded L-BFGS or, with
    ``optimizer_type=TRON``, sharded TRON with the block Hv factory.
    Normalization, variances and box constraints compose as in the
    reference. ``track_models``: each rank tracks its own block of every
    iterate and the fit gathers the blocks once, at its end, so every
    rank's results hold the whole per-iteration coefficients.
    ``tile_cache_dir``: the schedule cache for this rank's tiled cell."""
    regularization = RegularizationContext(regularization_type, elastic_net_alpha)
    fs = _feature_sharded_problem(
        batch, task, dim, mesh=mesh, regularization=regularization,
        max_iter=max_iter, tolerance=tolerance, history=history,
        normalization=normalization, compute_variances=compute_variances,
        box=box, intercept_index=intercept_index, kernel=kernel,
        optimizer_type=optimizer_type, track_models=track_models,
        tile_cache_dir=tile_cache_dir,
    )
    models: Models = {}
    results: Results = {}
    current = torch.zeros(fs.d_pad, device=mesh.device)
    for lam in _descending(regularization_weights):
        l1, l2 = regularization.split(lam)
        result, variances = fs.solve(current, l1, l2)
        models[lam] = fs.model(result.coefficients, variances)
        # the padded vector is only the warm-start currency
        results[lam] = _real_dims(result, dim)
        if warm_start:
            current = result.coefficients
    return models, results


def train_grid_batched_feature_sharded(
    batch: SparseBatch,
    task: TaskType,
    dim: int,
    *,
    mesh: ProcessMesh,
    regularization_type: RegularizationType = RegularizationType.NONE,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: Optional[float] = None,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    history: int = 10,
    normalization: Optional[NormalizationContext] = None,
    compute_variances: bool = False,
    box: Optional[BoxConstraints] = None,
    intercept_index: Optional[int] = None,
    kernel: str = "scatter",
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    track_models: bool = False,
    tile_cache_dir: Optional[str] = None,
) -> Tuple[Models, Results]:
    """Batched λ-grid twin of :func:`train_feature_sharded`: the grid is a
    ``[G, d_pad]`` bank whose feature axis is sharded over the mesh, every
    member a cold start from zero, one optimizer loop for all of them; on
    the tiled layout every cell pass over the bank is one K2 launch.
    ``track_models`` and ``tile_cache_dir`` as for
    :func:`train_feature_sharded`."""
    regularization = RegularizationContext(regularization_type, elastic_net_alpha)
    fs = _feature_sharded_problem(
        batch, task, dim, mesh=mesh, regularization=regularization,
        max_iter=max_iter, tolerance=tolerance, history=history,
        normalization=normalization, compute_variances=compute_variances,
        box=box, intercept_index=intercept_index, kernel=kernel,
        optimizer_type=optimizer_type, track_models=track_models,
        tile_cache_dir=tile_cache_dir,
    )
    weights_desc = _descending(regularization_weights)
    splits = [regularization.split(w) for w in weights_desc]
    l1_vec, l2_vec = (
        torch.tensor(v, dtype=torch.float32, device=mesh.device)
        for v in zip(*splits)
    )
    w0 = torch.zeros(len(weights_desc), fs.d_pad, device=mesh.device)
    result, variances = fs.solve(w0, l1_vec, l2_vec)
    models: Models = {}
    results: Results = {}
    for i, lam in enumerate(weights_desc):
        member = result.member(i)
        models[lam] = fs.model(
            member.coefficients, None if variances is None else variances[i]
        )
        results[lam] = _real_dims(member, dim)
    return models, results


def _real_dims(result: OptResult, dim: int) -> OptResult:
    """A mesh fit's result cut from the padded ``d_pad`` to the real
    dimension, tracked coefficients too."""
    tracker = result.tracker
    if tracker.coefs is not None:
        tracker = dataclasses.replace(tracker, coefs=tracker.coefs[..., :dim])
    return dataclasses.replace(
        result, coefficients=result.coefficients[..., :dim], tracker=tracker
    )


def iteration_models(
    result: OptResult,
    task: TaskType,
    normalization: Optional[NormalizationContext] = None,
    intercept_index: Optional[int] = None,
) -> List[GeneralizedLinearModel]:
    """Per-iteration models of one tracked fit (the ModelTracker analog):
    slot 0 is the initial point, slot i the accepted iterate i, in the
    original feature space exactly like the final model
    (GeneralizedLinearOptimizationProblem.scala:89-95)."""
    coefs = result.tracker.coefs
    if coefs is None:
        raise ValueError(
            "OptResult has no coefficient history; train with track_models=True"
        )
    problem = create_glm_problem(task, int(coefs.shape[-1]), intercept_index=intercept_index)
    return [
        problem.create_model(Coefficients(coefs[i]), normalization)
        for i in range(int(result.tracker.count))
    ]


def grid_result_scalars(results: Results) -> Dict[float, Tuple[int, float, int]]:
    """{lambda: (iterations, value, reason)} with ONE counted fetch for the
    whole grid (the iteration counts and reasons are on the host already;
    the values are not)."""
    items = list(results.items())
    values = fetch(torch.stack([res.value for _, res in items]))[0]
    return {
        lam: (int(res.iterations), float(v), int(res.reason))
        for (lam, res), v in zip(items, values)
    }


def train_streaming_glm(
    paths,
    task: TaskType,
    *,
    regularization_type: RegularizationType = RegularizationType.NONE,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: Optional[float] = None,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    history: int = 10,
    rows_per_chunk: int = 65536,
    cache_bytes: int = 2 << 30,
    prefetch: bool = True,
    kernel: str = "auto",
    tile_params=None,
    add_intercept: bool = True,
    field_names: str = "TRAINING_EXAMPLE",
    warm_start: bool = True,
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    normalization: Optional[NormalizationContext] = None,
    compute_variances: bool = False,
    box: Optional[BoxConstraints] = None,
    track_models: bool = False,
    fmt=None,
    index_map=None,
    stats=None,
    tile_cache_dir: Optional[str] = None,
    grid_checkpointer=None,
    preemption_guard=None,
    initial: Optional[Tensor] = None,
    device: DeviceLike = None,
    objective_out: Optional[list] = None,
):
    """Train a GLM over inputs LARGER than host RAM: every objective
    evaluation reads fixed-shape chunks from the cache tiers of a
    ``StreamingGLMObjective`` (the first one decodes the files and fills
    them), so host memory holds one decoded file + one staged chunk. The
    host-driven optimizers (``optim/host_lbfgs.py``, ``optim/host_tron.py``)
    walk the in-memory path's iterates. The reference's analog is Spark's
    MEMORY_AND_DISK persist under GLMSuite.readLabeledPointsFromAvro
    (io/GLMSuite.scala:98-131).

    L-BFGS; OWL-QN under L1 / elastic net with the intercept exempt; TRON
    with one streamed Hv pass per CG step. ``fmt``: an Avro (default) or
    LibSVM format of ``io/input_format.py``; ``index_map`` / ``stats`` from
    the caller's scan skip the trainer's own. ``normalization``: models
    come back in the original space; ``compute_variances``: 1 / (streamed
    Hessian diagonal + eps). ``initial``: the first λ's starting point
    (its dtype is the fit's). ``grid_checkpointer`` /
    ``preemption_guard``: per-λ snapshots and a stop at the λ boundary, as
    :func:`train_generalized_linear_model`. ``kernel`` and ``device`` as
    there (``device`` also holds the chunk tiers; the disk tier spills
    under ``$PHOTON_SPILL_DIR``, else the system temp directory).
    ``objective_out``: a list the streamed objective is appended to, for
    callers that read its counters. Several processes
    (``parallel/multihost.py``): each streams its shard of the files
    (``io.streaming.shard_stream_files``) and the partials of every
    evaluation are summed over the processes in rank order; this needs
    the prebuilt shared ``index_map``.

    Returns ({lambda: model}, {lambda: OptResult}, index_map).
    """
    from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat
    from photon_ml_tpu_torch.io.streaming import (
        StreamingGLMObjective,
        StreamStats,
        scan_stream,
        shard_stream_files,
    )
    from photon_ml_tpu_torch.optim.host_lbfgs import minimize_lbfgs_host, minimize_owlqn_host
    from photon_ml_tpu_torch.optim.host_tron import minimize_tron_host
    from photon_ml_tpu_torch.utils.index_map import intercept_key

    dev = resolve_device(device)
    regularization = RegularizationContext(regularization_type, elastic_net_alpha)
    use_tron = optimizer_type == OptimizerType.TRON
    base = OptimizerConfig.default_for(optimizer_type)
    max_iter = max_iter if max_iter is not None else base.max_iter
    tolerance = tolerance if tolerance is not None else base.tolerance
    validate_optimizer_choice(
        OptimizerConfig(optimizer_type=optimizer_type), regularization,
        loss_has_hessian=loss_for_task(task).has_hessian,
    )
    if fmt is None:
        fmt = AvroInputDataFormat(add_intercept=add_intercept, field_names=field_names)
    if multihost.process_count() > 1:
        # each process streams its shard of the files; every evaluation's
        # partials are summed over the processes in rank order
        if index_map is None:
            raise ValueError(
                "multi-process streaming requires a prebuilt shared index map "
                "(build one with the feature-indexing driver); no single "
                "process sees the whole vocabulary"
            )
        paths = shard_stream_files(paths, fmt)
        if stats is None:
            # local stats -> global agreement (the staging width must match);
            # a process without files joins with empty ones
            local = scan_stream(paths, fmt, index_map=index_map)[1] if paths else None
            counts = multihost.allgather_objects(
                (0, 1) if local is None else (local.num_rows, local.max_nnz)
            )
            stats = StreamStats(
                num_rows=sum(c[0] for c in counts), max_nnz=max(c[1] for c in counts)
            )
    elif index_map is None or stats is None:
        index_map, stats = scan_stream(paths, fmt, index_map=index_map)
    if normalization is not None:
        normalization = normalization.to(dev)
    if box is not None:
        box = BoxConstraints(box.lower.to(dev), box.upper.to(dev))
    objective = StreamingGLMObjective(
        paths, fmt, index_map, stats, task, rows_per_chunk=rows_per_chunk,
        cache_bytes=cache_bytes, prefetch=prefetch, kernel=kernel, tile_params=tile_params, norm=normalization,
        tile_cache_dir=tile_cache_dir, device=dev,
    )
    if objective_out is not None:
        objective_out.append(objective)
    intercept_index = None
    if fmt.add_intercept:
        icept = index_map.get_index(intercept_key())
        intercept_index = icept if icept >= 0 else None
    l1_mask = None
    if regularization.has_l1 and intercept_index is not None:
        l1_mask = torch.ones(objective.dim, device=dev)
        l1_mask[intercept_index] = 0.0
    problem = create_glm_problem(task, objective.dim, intercept_index=intercept_index)

    models: Models = {}
    results: Results = {}
    current = (
        torch.as_tensor(initial, device=dev) if initial is not None
        else torch.zeros(objective.dim, device=dev)
    )
    for lam in _descending(regularization_weights):
        snap = grid_checkpointer.load(lam) if grid_checkpointer is not None else None
        if snap is not None:
            models[lam] = _model_from_snapshot(task, snap, dev)
            results[lam] = _result_from_snapshot(snap["result"], dev)
            if warm_start:
                current = torch.as_tensor(snap["warm_means"], device=dev)
            continue
        if _stop_requested(preemption_guard):
            break
        l1, l2 = regularization.split(lam)

        def vg(w, l2=l2):
            return objective.value_and_gradient(w, l2)

        if use_tron:
            result = minimize_tron_host(
                vg, lambda w, d, l2=l2: objective.hessian_vector(w, d, l2), current,
                max_iter=max_iter, tol=tolerance, box=box,
                track_coefficients=track_models,
            )
        elif l1:
            result = minimize_owlqn_host(
                vg, current, l1, max_iter=max_iter, tol=tolerance, history=history,
                l1_mask=l1_mask, box=box, track_coefficients=track_models,
            )
        else:
            result = minimize_lbfgs_host(
                vg, current, max_iter=max_iter, tol=tolerance, history=history,
                box=box, track_coefficients=track_models,
            )
        variances = None
        if compute_variances:
            hd = objective.hessian_diagonal(result.coefficients, l2)
            variances = 1.0 / (hd + _VARIANCE_EPSILON)
        models[lam] = problem.create_model(
            Coefficients(result.coefficients, variances), normalization
        )
        results[lam] = result
        _maybe_save_snapshot(grid_checkpointer, lam, result.coefficients, models[lam], result)
        if warm_start:
            current = result.coefficients
    return models, results, index_map


def train_streaming_feature_sharded(
    paths,
    task: TaskType,
    *,
    mesh: ProcessMesh,
    regularization_type: RegularizationType = RegularizationType.NONE,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: Optional[float] = None,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    history: int = 10,
    rows_per_chunk: int = 65536,
    cache_bytes: int = 2 << 30,
    sharded_cache_bytes: int = 2 << 30,
    prefetch: bool = True,
    add_intercept: bool = True,
    field_names: str = "TRAINING_EXAMPLE",
    warm_start: bool = True,
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    compute_variances: bool = False,
    box: Optional[BoxConstraints] = None,
    track_models: bool = False,
    fmt=None,
    index_map=None,
    stats=None,
    spill_dir=None,
    grid_checkpointer=None,
    preemption_guard=None,
):
    """The streamed GLM over a feature-sharded coefficient vector on a
    (data, model) mesh of ranks (the reference's
    ``train_streaming_feature_sharded``, ranks for its devices): every rank
    calls it with the same arguments, streams every file and keeps its
    cell of each chunk (``io.streaming.FeatureShardedStreamingObjective``);
    the host-driven L-BFGS / OWL-QN / TRON walk the full ``[d_pad]``
    vector on each rank alike, TRON with one streamed sharded Hv pass per
    CG step. No normalization (as the reference's). ``grid_checkpointer``
    / ``preemption_guard`` as for :func:`train_generalized_linear_model`,
    the stop agreed by the ranks and the snapshots written by process 0.

    Returns ({lambda: model}, {lambda: OptResult}, index_map), the same on
    every rank."""
    from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat
    from photon_ml_tpu_torch.io.streaming import FeatureShardedStreamingObjective, scan_stream
    from photon_ml_tpu_torch.optim.host_lbfgs import minimize_lbfgs_host, minimize_owlqn_host
    from photon_ml_tpu_torch.optim.host_tron import minimize_tron_host
    from photon_ml_tpu_torch.utils.index_map import intercept_key

    dev = mesh.device
    regularization = RegularizationContext(regularization_type, elastic_net_alpha)
    use_tron = optimizer_type == OptimizerType.TRON
    base = OptimizerConfig.default_for(optimizer_type)
    max_iter = max_iter if max_iter is not None else base.max_iter
    tolerance = tolerance if tolerance is not None else base.tolerance
    validate_optimizer_choice(
        OptimizerConfig(optimizer_type=optimizer_type), regularization,
        loss_has_hessian=loss_for_task(task).has_hessian,
    )
    if fmt is None:
        fmt = AvroInputDataFormat(add_intercept=add_intercept, field_names=field_names)
    if index_map is None or stats is None:
        index_map, stats = scan_stream(paths, fmt, index_map=index_map)
    objective = FeatureShardedStreamingObjective(
        paths, fmt, index_map, stats, task, mesh, rows_per_chunk=rows_per_chunk,
        cache_bytes=cache_bytes, sharded_cache_bytes=sharded_cache_bytes,
        prefetch=prefetch, spill_dir=spill_dir,
    )
    dim, d_pad = objective.dim, objective.d_pad
    intercept_index = None
    if fmt.add_intercept:
        icept = index_map.get_index(intercept_key())
        intercept_index = icept if icept >= 0 else None
    l1_mask = None
    if regularization.has_l1:
        # the padded tail is exempt (its gradient is 0 and it stays 0), and
        # the intercept as on the replicated path
        l1_mask = torch.zeros(d_pad, device=dev)
        l1_mask[:dim] = 1.0
        if intercept_index is not None:
            l1_mask[intercept_index] = 0.0
    if box is not None:
        # padding coordinates are unbounded: the projection keeps them at 0
        inf = torch.full((d_pad - dim,), float("inf"), device=dev)
        box = BoxConstraints(
            torch.cat([box.lower.to(dev), -inf]), torch.cat([box.upper.to(dev), inf])
        )
    problem = create_glm_problem(task, dim, intercept_index=intercept_index)

    models: Models = {}
    results: Results = {}
    current = torch.zeros(d_pad, device=dev)
    for lam in _descending(regularization_weights):
        snap = grid_checkpointer.load(lam) if grid_checkpointer is not None else None
        if snap is not None:
            models[lam] = _model_from_snapshot(task, snap, dev)
            results[lam] = _result_from_snapshot(snap["result"], dev)
            if warm_start:
                current = torch.as_tensor(snap["warm_means"], device=dev)
            continue
        if _stop_requested(preemption_guard, mesh):
            break
        l1, l2 = regularization.split(lam)

        def vg(w, l2=l2):
            return objective.value_and_gradient(w, l2)

        if use_tron:
            result = minimize_tron_host(
                vg, lambda w, d, l2=l2: objective.hessian_vector(w, d, l2), current,
                max_iter=max_iter, tol=tolerance, box=box,
                track_coefficients=track_models,
            )
        elif l1:
            result = minimize_owlqn_host(
                vg, current, l1, max_iter=max_iter, tol=tolerance, history=history,
                l1_mask=l1_mask, box=box, track_coefficients=track_models,
            )
        else:
            result = minimize_lbfgs_host(
                vg, current, max_iter=max_iter, tol=tolerance, history=history,
                box=box, track_coefficients=track_models,
            )
        variances = None
        if compute_variances:
            hd = objective.hessian_diagonal(result.coefficients, l2)
            variances = (1.0 / (hd + _VARIANCE_EPSILON))[:dim]
        models[lam] = problem.create_model(
            Coefficients(result.coefficients[:dim], variances)
        )
        results[lam] = _real_dims(result, dim)
        _maybe_save_snapshot(grid_checkpointer, lam, result.coefficients, models[lam], results[lam])
        if warm_start:
            current = result.coefficients
    return models, results, index_map
