"""GLM training over a λ-grid (port of ``photon_ml_tpu/training.py``):

- ``train_generalized_linear_model``: one fit per λ, warm-started.
  Reference: photon-ml ModelTraining.scala:103-215: one problem per task,
  regularization weights sorted DESCENDING (:172), each lambda
  warm-started from the previous one's coefficients (:183-208).
- ``train_grid_batched``: the whole grid as one bank ``[G, d]`` of cold
  starts, every data pass shared by all members (K2 on the card), and
  ``resolve_grid_mode``, the policy that picks between the two.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.tiled_sparse import (
    TiledSparseBatch,
    tiled_batch_from_sparse,
)
from photon_ml_tpu_torch.optim.common import BoxConstraints, OptResult, fetch
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import (
    GLMOptimizationProblem,
    create_glm_problem,
    resolve_kernel,
)
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


Models = Dict[float, GeneralizedLinearModel]
Results = Dict[float, OptResult]


def _problem_on_device(
    batch, task, dim, *, optimizer_type, regularization_type,
    elastic_net_alpha, max_iter, tolerance, normalization, compute_variances,
    box, intercept_index, kernel, device,
) -> Tuple[GLMOptimizationProblem, object, Optional[NormalizationContext]]:
    """The problem both trainers solve, with the batch (tiled for the
    tiled kernel) and the other tensors moved to ``device``."""
    dev = resolve_device(device)
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
    if kernel == "tiled":
        if isinstance(batch, SparseBatch):
            batch = tiled_batch_from_sparse(batch, dim, device=dev)
        elif not isinstance(batch, TiledSparseBatch):
            raise TypeError(
                "kernel='tiled' requires a SparseBatch or TiledSparseBatch, "
                f"got {type(batch).__name__}"
            )
    elif not isinstance(batch, SparseBatch):
        raise TypeError(
            f"kernel='scatter' requires a SparseBatch, got {type(batch).__name__}"
        )
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
    """
    problem, batch, normalization = _problem_on_device(
        batch, task, dim, optimizer_type=optimizer_type,
        regularization_type=regularization_type,
        elastic_net_alpha=elastic_net_alpha, max_iter=max_iter,
        tolerance=tolerance, normalization=normalization,
        compute_variances=compute_variances, box=box,
        intercept_index=intercept_index, kernel=kernel, device=device,
    )
    # strongest regularization first, so each warm start relaxes an
    # already-shrunk model
    models: Models = {}
    results: Results = {}
    dev = batch.labels.device
    current = None if initial is None else torch.as_tensor(initial, device=dev)
    for lam in _descending(regularization_weights):
        coefficients, result = problem.run(batch, initial=current, reg_weight=lam)
        models[lam] = problem.create_model(coefficients, normalization)
        results[lam] = result
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
) -> int:
    """Estimated bytes of the batched grid's [G, d] bank plus each
    member's optimizer state: L-BFGS's [m, d] s/y buffers dominate; TRON
    carries the CG vectors instead."""
    if optimizer_type == OptimizerType.TRON:
        vectors_per_member = 12  # w, g + CG s/r/d/hd + trial w/g + slack
    else:
        vectors_per_member = 2 * history + 8
    return int(num_weights) * vectors_per_member * int(dim) * 4


def resolve_grid_mode(
    mode: str,
    *,
    num_weights: int,
    dim: int,
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    history: int = 10,
    memory_budget_bytes: int = DEFAULT_GRID_MEMORY_BUDGET,
    streaming: bool = False,
) -> str:
    """Resolve ``--grid-mode {batched,sequential,auto}`` to a path.
    ``auto`` picks batched when the grid has more than one member, the
    data is in memory (not streaming) and the bank fits the budget
    (:func:`grid_bank_bytes`); else sequential. An explicit ``batched``
    with streaming input is a configuration error."""
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
    bank = grid_bank_bytes(num_weights, dim, optimizer_type, history)
    return "batched" if bank <= memory_budget_bytes else "sequential"


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
    device for :func:`grid_result_scalars`' one fetch. ``kernel`` and
    ``device`` as for the sequential trainer ("auto" is the tiled kernel
    on the card).
    """
    problem, batch, normalization = _problem_on_device(
        batch, task, dim, optimizer_type=optimizer_type,
        regularization_type=regularization_type,
        elastic_net_alpha=elastic_net_alpha, max_iter=max_iter,
        tolerance=tolerance, normalization=normalization,
        compute_variances=compute_variances, box=box,
        intercept_index=intercept_index, kernel=kernel, device=device,
    )
    weights_desc = _descending(regularization_weights)
    variances, result = problem.run_grid(batch, weights_desc, initial=initial)
    models: Models = {}
    results: Results = {}
    for i, lam in enumerate(weights_desc):
        var_i = variances[i] if variances is not None else None
        coefficients = Coefficients(result.coefficients[i], var_i)
        models[lam] = problem.create_model(coefficients, normalization)
        results[lam] = result.member(i)
    return models, results


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
