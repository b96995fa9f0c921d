"""Shared optimizer machinery: convergence, line search, tracking,
projection (port of ``photon_ml_tpu/optim/common.py``).

Reference: photon-ml .../optimization/Optimizer.scala (convergence checks
at 156-170), OptimizationStatesTracker.scala, OptimizationUtils.

The reference runs its optimizers as ``lax.while_loop`` programs. Here the
loop is Python over tensors that stay on the device; the host reads only
the scalars that decide control flow, batched into one copy by
:func:`fetch`. ``host_fetches`` counts those copies: one per line-search
trial, one per CG step and one per outer iteration.

Convergence reasons mirror the reference's:
  MAX_ITERATIONS, FUNCTION_VALUES_WITHIN_TOLERANCE (|f_k - f_{k-1}| <=
  tol |f_0|), GRADIENT_WITHIN_TOLERANCE (||g_k|| <= tol ||g_0||) and
  LINE_SEARCH_STALLED (no decreasing step found).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

Tensor = torch.Tensor

NOT_CONVERGED = 0
MAX_ITERATIONS = 1
FUNCTION_VALUES_WITHIN_TOLERANCE = 2
GRADIENT_WITHIN_TOLERANCE = 3
LINE_SEARCH_STALLED = 4

CONVERGENCE_REASON_NAMES = {
    NOT_CONVERGED: "NotConverged",
    MAX_ITERATIONS: "MaxIterations",
    FUNCTION_VALUES_WITHIN_TOLERANCE: "FunctionValuesWithinTolerance",
    GRADIENT_WITHIN_TOLERANCE: "GradientWithinTolerance",
    LINE_SEARCH_STALLED: "LineSearchStalled",
}

# Device-to-host copies made by fetch() (a run sets it to 0 and reads it).
host_fetches = 0


def fetch(*scalars: Tensor) -> List[float]:
    """Copy a few 0-d tensors to the host in ONE transfer; counted."""
    global host_fetches
    host_fetches += 1
    return torch.stack([s.to(torch.float64) for s in scalars]).tolist()


@dataclass(frozen=True)
class BoxConstraints:
    """Per-coefficient [lower, upper] box; +-inf for unconstrained."""

    lower: Tensor
    upper: Tensor

    def project(self, w: Tensor) -> Tensor:
        return torch.clamp(w, self.lower, self.upper)


@dataclass
class Tracker:
    """Per-iteration trace: value and gradient norm of the initial point
    and of every iteration (device scalars)."""

    values: List[Tensor] = field(default_factory=list)
    grad_norms: List[Tensor] = field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.values)

    def record(self, value: Tensor, grad_norm: Tensor):
        self.values.append(value)
        self.grad_norms.append(grad_norm)


@dataclass
class OptResult:
    """Result of one optimize() call."""

    coefficients: Tensor
    value: Tensor
    grad_norm: Tensor
    iterations: int
    reason: int
    tracker: Tracker

    @property
    def reason_name(self) -> str:
        return CONVERGENCE_REASON_NAMES.get(self.reason, "?")


def check_convergence(
    iteration: int,
    f_prev: Tensor,
    f_cur: Tensor,
    g_norm: Tensor,
    f0: Tensor,
    g0_norm: Tensor,
    *,
    max_iter: int,
    tol: float,
) -> Tensor:
    """Convergence-reason code (0 if not converged), on the device;
    relative tests against the initial state (Optimizer.scala:156-170)."""
    reason = torch.where(
        torch.abs(f_cur - f_prev) <= tol * torch.abs(f0),
        FUNCTION_VALUES_WITHIN_TOLERANCE,
        NOT_CONVERGED,
    )
    reason = torch.where(g_norm <= tol * g0_norm, GRADIENT_WITHIN_TOLERANCE, reason)
    if iteration >= max_iter:
        reason = torch.where(reason == NOT_CONVERGED, MAX_ITERATIONS, reason)
    return reason


ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]


@dataclass
class LineSearchResult:
    step: Tensor
    w: Tensor
    f: Tensor
    g: Tensor
    ok: bool  # sufficient decrease achieved


def backtracking_line_search(
    vg: ValueAndGrad,
    w: Tensor,
    f: Tensor,
    g: Tensor,
    direction: Tensor,
    t0: Tensor,
    *,
    c1: float = 1e-4,
    shrink: float = 0.5,
    max_steps: int = 24,
    project: Optional[Callable[[Tensor], Tensor]] = None,
) -> LineSearchResult:
    """Armijo backtracking, projecting each trial point; one objective
    evaluation and one host fetch per trial. A search that finds no
    decreasing step keeps the original point (``ok=False``)."""

    def trial(t):
        w_t = w + t * direction
        if project is not None:
            w_t = project(w_t)
        f_t, g_t = vg(w_t)
        return w_t, f_t, g_t

    def armijo_ok(w_t, f_t) -> bool:
        ok = (f_t <= f + c1 * torch.dot(g, w_t - w)) & torch.isfinite(f_t)
        return bool(fetch(ok)[0])

    t = t0
    w_t, f_t, g_t = trial(t)
    ok = armijo_ok(w_t, f_t)
    k = 0
    while not ok and k < max_steps:
        t = t * shrink
        w_t, f_t, g_t = trial(t)
        ok = armijo_ok(w_t, f_t)
        k += 1
    if not ok:
        return LineSearchResult(step=t, w=w, f=f, g=g, ok=False)
    return LineSearchResult(step=t, w=w_t, f=f_t, g=g_t, ok=True)
