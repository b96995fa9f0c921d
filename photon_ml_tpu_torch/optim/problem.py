"""GLM optimization problems: optimizer + objective + model construction
(port of ``photon_ml_tpu/optim/problem.py``): one fit (``run``) or the
whole λ-grid over a coefficient bank (``run_grid``), on one device or, with
``mesh``, data-parallel over the ranks of a mesh (each rank holds one
shard of the rows, the coefficients are replicated, and the objective
sums its partials over the data group: the reference's ``shard_map`` with
``with_axis``).

Reference: photon-ml .../optimization/GeneralizedLinearOptimizationProblem.
scala (run at :112-121, de-normalization at :89-95) and
DistributedOptimizationProblem.scala (variances 1/(Hdiag + eps) at
:79-93).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.data.sampler import down_sample
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, create_model
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationContext,
    identity_context,
)
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.ops.tiled_sparse import (
    TiledGLMObjective,
    TiledSparseBatch,
    ensure_tiled,
    ensure_tiled_sharded,
)
from photon_ml_tpu_torch.optim.common import (
    BoxConstraints,
    MeshReductions,
    OptResult,
)
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
)
from photon_ml_tpu_torch.optim.factory import make_optimizer
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, ProcessMesh
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

# Added when inverting the Hessian diagonal
# (DistributedOptimizationProblem.scala:79-93).
_VARIANCE_EPSILON = 1e-12


@dataclass(frozen=True)
class GLMOptimizationProblem:
    """One (task, optimizer, regularization) problem over a coefficient
    dimension, reused across a lambda grid (the weight is an argument)."""

    task: TaskType
    objective: object  # GLMObjective or TiledGLMObjective
    config: OptimizerConfig = field(default_factory=OptimizerConfig)
    regularization: RegularizationContext = field(default_factory=RegularizationContext)
    compute_variances: bool = False
    box: Optional[BoxConstraints] = None
    intercept_index: Optional[int] = None

    def _l1_mask(self, device) -> Optional[Tensor]:
        """The intercept is exempt from the L1 penalty."""
        if self.intercept_index is None:
            return None
        mask = torch.ones(self.objective.dim, device=device)
        mask[self.intercept_index] = 0.0
        return mask

    def _prepare(self, batch, mesh: Optional[ProcessMesh]):
        """The tiled objective's batch: a SparseBatch is tiled
        (``ensure_tiled``, or on a mesh this rank's shard of the
        data-parallel layout, ``ensure_tiled_sharded``; both reuse the
        schedules of a batch converted before). On a mesh the scatter
        objective's ``batch`` is this rank's data shard
        (``parallel.mesh.data_shard_sparse_batch``)."""
        if isinstance(self.objective, TiledGLMObjective):
            if isinstance(batch, SparseBatch):
                batch = (
                    ensure_tiled(batch, self.objective.dim, device=batch.device)
                    if mesh is None
                    else ensure_tiled_sharded(batch, self.objective.dim, mesh)
                )
            if not isinstance(batch, TiledSparseBatch):
                raise TypeError(
                    "the tiled objective takes a SparseBatch or a "
                    f"TiledSparseBatch, got {type(batch).__name__}"
                )
            shards = 1 if mesh is None else mesh.size(DATA_AXIS)
            if batch.meta.data_shards != shards:
                raise ValueError(
                    f"the tiled batch is laid out for {batch.meta.data_shards} "
                    f"data shards, the mesh has {shards}"
                )
        return batch

    def _solve(
        self, batch, w0: Tensor, l1, l2, mesh: Optional[ProcessMesh],
        track_models: bool = False,
    ) -> Tuple[OptResult, Optional[Tensor]]:
        """Optimize from ``w0`` ([d] with scalar weights, or a bank [G, d]
        with weights [G]); -> (result, variances or None)."""
        objective = self.objective
        reductions = None
        if mesh is not None:
            objective = dataclasses.replace(objective, group=mesh.groups[DATA_AXIS])
            reductions = MeshReductions(model=None, world=mesh.world)
        optimize = make_optimizer(
            self.config, self.regularization,
            loss_has_hessian=objective.loss.has_hessian,
            box=self.box, l1_mask=self._l1_mask(w0.device), mesh=reductions,
            track_coefficients=track_models,
        )

        def vg(w):
            return objective.value_and_gradient(w, batch, l2)

        def hvp(w, d):
            return objective.hessian_vector(w, d, batch, l2)

        needs_hvp = self.config.optimizer_type == OptimizerType.TRON
        result = optimize(vg, w0, l1_weight=l1, hvp_fn=hvp if needs_hvp else None)
        variances = None
        if self.compute_variances:
            hdiag = objective.hessian_diagonal(result.coefficients, batch, l2)
            variances = 1.0 / (hdiag + _VARIANCE_EPSILON)
        return result, variances

    def run(
        self,
        batch,
        initial: Optional[Tensor] = None,
        reg_weight: float = 0.0,
        mesh: Optional[ProcessMesh] = None,
        track_models: bool = False,
    ) -> Tuple[Coefficients, OptResult]:
        """Optimize and build coefficients (+ variances if requested).
        The batch's device is where the fit runs. With ``mesh`` every rank
        calls it with its shard (see ``_prepare``) and gets the same
        result. ``track_models`` keeps every iterate in
        ``result.tracker.coefs`` (the ModelTracker analog behind
        validate-per-iteration, Driver.scala:329-372)."""
        batch = self._prepare(batch, mesh)
        device = batch.labels.device
        w0 = (
            torch.zeros(self.objective.dim, device=device)
            if initial is None
            else torch.as_tensor(initial, dtype=torch.float32, device=device)
        )
        l1, l2 = self.regularization.split(reg_weight)
        result, variances = self._solve(batch, w0, l1, l2, mesh, track_models)
        return Coefficients(result.coefficients, variances), result

    def run_grid(
        self,
        batch,
        reg_weights: Sequence[float],
        initial: Optional[Tensor] = None,
        mesh: Optional[ProcessMesh] = None,
        track_models: bool = False,
        offsets_bank: Optional[Tensor] = None,
    ) -> Tuple[Optional[Tensor], OptResult]:
        """Solve the whole λ grid at once over a [G, d] coefficient bank.

        ``reg_weights`` is the λ sequence (member i is ``reg_weights[i]``);
        ``initial`` is a [d] vector broadcast to every member or a [G, d]
        bank. Members do NOT warm-start from each other. Every data pass
        serves the whole bank (K2 on the tiled objective), converged
        members freeze while the others run on, and the host fetches per
        trip do not grow with G. -> (variances bank [G, d] or None, the
        bank's OptResult, every field with a leading grid axis; a frozen
        member's tracked slots stop changing). ``mesh`` and
        ``track_models`` as for :meth:`run`.

        ``offsets_bank`` ([G, n]) gives each member its OWN row offsets
        (``batch.offsets`` is ignored): the unified-mesh GAME trainer's
        per-member residual currency. Columns short of the padded row
        count (on a mesh, of every shard's rows) are zero-extended; on a
        mesh each rank takes its shard's columns."""
        batch = self._prepare(batch, mesh)
        device = batch.labels.device
        splits = [self.regularization.split(float(w)) for w in reg_weights]
        l1_vec = torch.tensor([s[0] for s in splits], dtype=torch.float32, device=device)
        l2_vec = torch.tensor([s[1] for s in splits], dtype=torch.float32, device=device)
        shape = (len(splits), self.objective.dim)
        if initial is None:
            w0 = torch.zeros(shape, device=device)
        else:
            w0 = torch.as_tensor(initial, dtype=torch.float32, device=device)
            w0 = w0.expand(shape).contiguous()
        if offsets_bank is not None:
            batch = dataclasses.replace(
                batch, offsets=_member_offsets(offsets_bank, batch, len(splits), mesh)
            )
        result, variances = self._solve(
            batch, w0, l1_vec, l2_vec, mesh, track_models
        )
        return variances, result

    def run_with_sampling(
        self,
        batch,
        generator: torch.Generator,
        down_sampling_rate: float,
        initial: Optional[Tensor] = None,
        reg_weight: float = 0.0,
        mesh: Optional[ProcessMesh] = None,
        track_models: bool = False,
    ) -> Tuple[Coefficients, OptResult]:
        """Down-sample the rows with the task's sampler first
        (DistributedOptimizationProblem.runWithSampling:112-124), drawing
        from ``generator``; a rate of 1 or more samples nothing."""
        if down_sampling_rate < 1.0:
            batch = down_sample(generator, batch, down_sampling_rate, self.task)
        return self.run(
            batch, initial, reg_weight, mesh=mesh, track_models=track_models
        )

    def create_model(
        self,
        coefficients: Coefficients,
        norm: Optional[NormalizationContext] = None,
    ) -> GeneralizedLinearModel:
        """Build the model with coefficients mapped back to the raw feature
        space (GeneralizedLinearOptimizationProblem.scala:89-95)."""
        norm = norm if norm is not None else identity_context()
        if not norm.is_identity:
            means = norm.model_to_original_space(coefficients.means)
            if self.intercept_index is not None:
                means = means.clone()
                means[self.intercept_index] += norm.intercept_adjustment(
                    coefficients.means
                )
            coefficients = Coefficients(means, coefficients.variances)
        return create_model(self.task, coefficients)


def _member_offsets(offsets_bank, batch, members: int, mesh: Optional[ProcessMesh]) -> Tensor:
    """``[G, n]`` offsets -> this batch's ``[G, rows]`` (zero-extended to the
    padded rows of every shard, then this rank's shard's columns)."""
    rows = batch.labels.shape[0]
    shards, index = (1, 0) if mesh is None else (mesh.size(DATA_AXIS), mesh.index(DATA_AXIS))
    off = torch.as_tensor(offsets_bank, dtype=batch.offsets.dtype, device=batch.labels.device)
    if off.dim() != 2 or off.shape[0] != members:
        raise ValueError(
            f"offsets_bank must be [{members}, n] (a row per member), got {tuple(off.shape)}"
        )
    total = shards * rows
    if off.shape[1] > total:
        raise ValueError(f"offsets_bank has {off.shape[1]} columns for {total} rows")
    off = torch.nn.functional.pad(off, (0, total - off.shape[1]))
    return off[:, index * rows:(index + 1) * rows].contiguous()


def resolve_kernel(kernel: str, device: DeviceLike = None) -> str:
    """"scatter" | "tiled" | "auto": "auto" is the tiled objective (and so
    the CUDA kernel) on the card and the scatter objective on the CPU."""
    if kernel not in ("auto", "tiled", "scatter"):
        raise ValueError(f"unknown kernel {kernel!r}; expected auto | tiled | scatter")
    if kernel != "auto":
        return kernel
    return "tiled" if resolve_device(device).type == "cuda" else "scatter"


def create_glm_problem(
    task: TaskType,
    dim: int,
    *,
    config: Optional[OptimizerConfig] = None,
    regularization: Optional[RegularizationContext] = None,
    norm: Optional[NormalizationContext] = None,
    compute_variances: bool = False,
    box: Optional[BoxConstraints] = None,
    intercept_index: Optional[int] = None,
    kernel: str = "scatter",
) -> GLMOptimizationProblem:
    """``kernel``: "scatter" (GLMObjective over a SparseBatch) or "tiled"
    (TiledGLMObjective over a TiledSparseBatch); both share one contract."""
    norm_ctx = norm if norm is not None else identity_context()
    if kernel not in ("tiled", "scatter"):
        raise ValueError(f"unknown kernel {kernel!r}; expected tiled | scatter")
    cls = TiledGLMObjective if kernel == "tiled" else GLMObjective
    return GLMOptimizationProblem(
        task=task,
        objective=cls(loss_for_task(task), dim, norm_ctx),
        config=config if config is not None else OptimizerConfig(),
        regularization=(
            regularization if regularization is not None else RegularizationContext()
        ),
        compute_variances=compute_variances,
        box=box,
        intercept_index=intercept_index,
    )

