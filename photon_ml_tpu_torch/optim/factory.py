"""Optimizer selection rules (port of ``photon_ml_tpu/optim/factory.py``).

Reference: photon-ml .../optimization/OptimizerFactory.scala:49-86:
(LBFGS, L1/ELASTIC_NET) -> OWL-QN; (LBFGS, L2/NONE) -> LBFGS;
(TRON, L2/NONE) -> TRON; TRON with any L1 is rejected, as is TRON for the
once-differentiable smoothed hinge loss (Params.scala:200-222).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.optim.common import (
    BoxConstraints,
    MeshReductions,
    OptResult,
    ValueAndGrad,
)
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
)
from photon_ml_tpu_torch.optim.lbfgs import minimize_lbfgs, minimize_owlqn
from photon_ml_tpu_torch.optim.tron import minimize_tron

Tensor = torch.Tensor


def validate_optimizer_choice(
    config: OptimizerConfig,
    regularization: RegularizationContext,
    *,
    loss_has_hessian: bool = True,
) -> None:
    if config.optimizer_type == OptimizerType.TRON:
        if regularization.has_l1:
            raise ValueError(
                "TRON does not support L1/ELASTIC_NET regularization "
                "(OptimizerFactory.scala:49-86)"
            )
        if not loss_has_hessian:
            raise ValueError(
                "TRON requires a twice-differentiable loss; the smoothed "
                "hinge loss is only once-differentiable"
            )


def make_optimizer(
    config: OptimizerConfig,
    regularization: RegularizationContext,
    *,
    loss_has_hessian: bool = True,
    box: Optional[BoxConstraints] = None,
    l1_mask: Optional[Tensor] = None,
    mesh: Optional[MeshReductions] = None,
    track_coefficients: bool = False,
) -> Callable[..., OptResult]:
    """Build ``optimize(value_and_grad_fn, w0, l1_weight=0.0, hvp_fn=None,
    hvp_factory=None)``, one signature for L-BFGS, OWL-QN and TRON, over a
    vector ``w0`` [d] or a bank [G, d] (then ``l1_weight`` may be one
    weight per member). ``mesh``: the optimizers' reductions on a mesh of
    ranks (``optim/common.py``). ``track_coefficients``: keep every
    iterate in the result's tracker."""
    validate_optimizer_choice(config, regularization, loss_has_hessian=loss_has_hessian)
    use_owlqn = regularization.has_l1

    def optimize(
        value_and_grad_fn: ValueAndGrad, w0: Tensor, *, l1_weight=0.0,
        hvp_fn=None, hvp_factory=None,
    ) -> OptResult:
        if config.optimizer_type == OptimizerType.TRON:
            if hvp_fn is None and hvp_factory is None:
                raise ValueError("TRON requires hvp_fn or hvp_factory")
            return minimize_tron(
                value_and_grad_fn, hvp_fn, w0,
                max_iter=config.max_iter, tol=config.tolerance,
                max_cg=config.tron_max_cg, box=box, hvp_factory=hvp_factory,
                mesh=mesh, track_coefficients=track_coefficients,
            )
        if use_owlqn:
            return minimize_owlqn(
                value_and_grad_fn, w0, l1_weight,
                max_iter=config.max_iter, tol=config.tolerance,
                history=config.lbfgs_history, l1_mask=l1_mask, box=box,
                mesh=mesh, track_coefficients=track_coefficients,
            )
        return minimize_lbfgs(
            value_and_grad_fn, w0,
            max_iter=config.max_iter, tol=config.tolerance,
            history=config.lbfgs_history, box=box, mesh=mesh,
            track_coefficients=track_coefficients,
        )

    return optimize
