"""GLM training: a regularization path with warm starts (port of
``train_generalized_linear_model`` in ``photon_ml_tpu/training.py``).

Reference: photon-ml ModelTraining.scala:103-215: one problem per task,
regularization weights sorted DESCENDING (:172), each lambda warm-started
from the previous one's coefficients (:183-208).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.tiled_sparse import (
    TiledSparseBatch,
    tiled_batch_from_sparse,
)
from photon_ml_tpu_torch.optim.common import BoxConstraints, OptResult
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import create_glm_problem, resolve_kernel
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


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
) -> Tuple[Dict[float, GeneralizedLinearModel], Dict[float, OptResult]]:
    """Train one model per regularization weight with warm starts.

    Returns ({lambda: model}, {lambda: OptResult}); models are in the
    ORIGINAL feature space (normalization undone).

    ``kernel``: "scatter" | "tiled" | "auto" (see
    ``optim.problem.resolve_kernel``). For "tiled" a SparseBatch is tiled
    once here with the default TileParams; pass a TiledSparseBatch to
    choose them. ``device`` (default: the CUDA card) is where the fit runs;
    the batch and the other tensors are moved there.
    """
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

    # strongest regularization first, so each warm start relaxes an
    # already-shrunk model (ModelTraining.scala:172)
    weights_desc: List[float] = sorted(
        set(float(w) for w in regularization_weights), reverse=True
    )
    models: Dict[float, GeneralizedLinearModel] = {}
    results: Dict[float, OptResult] = {}
    current = None if initial is None else torch.as_tensor(initial, device=dev)
    for lam in weights_desc:
        coefficients, result = problem.run(batch, initial=current, reg_weight=lam)
        models[lam] = problem.create_model(coefficients, normalization)
        results[lam] = result
        if warm_start:
            current = coefficients.means
    return models, results
