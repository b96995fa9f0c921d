"""Host-driven TRON for objectives whose evaluations run host code (port of
``photon_ml_tpu/optim/host_tron.py``): the streamed objective's value,
gradient and Hessian-vector products each read the chunk tiers.

The math is ``optim/tron.py``'s for one vector: the LIBLINEAR eta / sigma
trust-region rules, Steihaug truncated CG (at most ``max_cg`` steps, one
streamed Hv pass each: the reference's one cluster aggregate per CG step,
HessianVectorAggregator.scala:137-152 + TRON.scala:259-341) and the shared
convergence rules, driven from Python with the reference's readback
discipline through the counted ``overlap.device_get`` seam: per CG step
one residual check and one (d.Hd, d.d, s.d, s.s) batch, and per outer
iteration one batch of the step's and the model's scalars with the
convergence reason.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.optim.common import (
    GRADIENT_WITHIN_TOLERANCE,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    BoxConstraints,
    OptResult,
)
from photon_ml_tpu_torch.optim.host_lbfgs import HostTracker, converged, f32, start_point
from photon_ml_tpu_torch.optim.tron import (
    _ETA0,
    _ETA1,
    _ETA2,
    _SIGMA1,
    _SIGMA2,
    _SIGMA3,
)
from photon_ml_tpu_torch.parallel import overlap

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]


def _truncated_cg_host(
    hvp, g: Tensor, delta: float, *, max_cg: int, cg_tol_factor: float = 0.1,
    g_norm: Optional[float] = None,
):
    """Steihaug truncated CG: each step is ONE ``hvp`` call (one streamed
    pass) and two batched fetches. -> (s, r) with r = -g - H s (the
    tron.cpp prered trick). ``g_norm``: the caller's fetched ||g||."""
    if g_norm is None:
        g_norm = float(overlap.device_get(torch.linalg.norm(g)))
    cg_tol = cg_tol_factor * g_norm
    s = torch.zeros_like(g)
    r = -g
    d = r
    rtr = g_norm * g_norm
    for _ in range(max_cg):
        if np.sqrt(max(rtr, 0.0)) <= cg_tol:
            break
        hd = hvp(d)
        # ONE batch: the curvature and the boundary geometry's scalars
        dhd, dd, sd, ss = (
            float(v) for v in overlap.device_get((
                torch.dot(d, hd), torch.dot(d, d), torch.dot(s, d), torch.dot(s, s),
            ))
        )
        alpha = rtr / dhd if dhd > 0 else 0.0
        s_new_sq = ss + 2.0 * alpha * sd + alpha * alpha * dd
        if dhd <= 0 or np.sqrt(max(s_new_sq, 0.0)) >= delta:
            # walk to the trust-region boundary and stop
            rad = np.sqrt(max(sd * sd + dd * (delta * delta - ss), 0.0))
            tau = (-sd + rad) / max(dd, 1e-30)
            s = s + tau * d
            r = r - tau * hd
            break
        s = s + alpha * d
        r = r - alpha * hd
        rtr_new = float(overlap.device_get(torch.dot(r, r)))
        beta = rtr_new / max(rtr, 1e-30)
        d = r + beta * d
        rtr = rtr_new
    return s, r


def minimize_tron_host(
    value_and_grad_fn: ValueAndGrad,
    hvp_fn: Callable[[Tensor, Tensor], Tensor],
    w0: Tensor,
    *,
    max_iter: int = 15,
    tol: float = 1e-5,
    max_cg: int = 20,
    max_improvement_failures: int = 16,
    box: Optional[BoxConstraints] = None,
    hvp_factory=None,
    track_coefficients: bool = False,
) -> OptResult:
    """Trust-region Newton whose evaluations run host code (defaults of
    TRON.scala:260-265). ``hvp_fn(w, d) -> H(w) @ d``; ``hvp_factory(w) ->
    (d -> H(w) @ d)`` lets the caller keep the w-only pieces for one outer
    iteration. With ``box`` a trial point is projected, and the model
    reduction re-evaluated at the projected step (one more Hv pass)."""
    w = start_point(w0, box)
    f_dev, g = value_and_grad_fn(w)
    f, g0_norm = (float(v) for v in overlap.device_get((f_dev, torch.linalg.norm(g))))
    f0 = f
    g_norm = g0_norm
    delta = g0_norm
    tracker = HostTracker(max_iter + 1, track_coefficients)
    tracker.record(f, f32(g0_norm), w)
    reason = GRADIENT_WITHIN_TOLERANCE if g0_norm == 0.0 else NOT_CONVERGED
    it = 0
    failures = 0
    while reason == NOT_CONVERGED:
        hvp = hvp_factory(w) if hvp_factory is not None else (lambda d, _w=w: hvp_fn(_w, d))
        s, r = _truncated_cg_host(hvp, g, delta, max_cg=max_cg, g_norm=g_norm)
        w_trial = w + s
        s_raw = s
        if box is not None:
            w_trial = box.project(w_trial)
            s = w_trial - w
        f_new_dev, g_new = value_and_grad_fn(w_trial)
        g_norm_dev = torch.linalg.norm(g_new)
        # the OUTER iteration's batch: every step and model scalar and the
        # convergence reason, in ONE fetch
        gs, s_r, f_new, snorm, g_norm_new, projected_any, reason_new = overlap.device_get((
            torch.dot(g, s), torch.dot(s, r), f_new_dev, torch.linalg.norm(s), g_norm_dev,
            torch.any(s != s_raw) if box is not None else torch.tensor(False),
            converged(
                it + 1, f, f_new_dev, g_norm_dev, f0, g0_norm, max_iter=max_iter, tol=tol,
                round_new=False,
            ),
        ))
        gs, f_new, snorm = float(gs), float(f_new), float(snorm)
        if bool(projected_any):
            # the CG residual belongs to the UNPROJECTED step: with an
            # active box the model is re-evaluated at the projected s
            prered = -(gs + 0.5 * float(overlap.device_get(torch.dot(s, hvp(s)))))
        else:
            prered = -0.5 * (gs - float(s_r))
        actred = f - f_new

        denom = f_new - f - gs
        alpha = _SIGMA3 if denom <= 0 else max(_SIGMA1, -0.5 * (gs / denom))
        if actred < _ETA0 * prered:
            delta = min(max(alpha, _SIGMA1) * snorm, _SIGMA2 * delta)
        elif actred < _ETA1 * prered:
            delta = max(_SIGMA1 * delta, min(alpha * snorm, _SIGMA2 * delta))
        elif actred < _ETA2 * prered:
            delta = max(_SIGMA1 * delta, min(alpha * snorm, _SIGMA3 * delta))
        else:
            delta = max(delta, min(alpha * snorm, _SIGMA3 * delta))

        it += 1
        if actred > _ETA0 * prered and np.isfinite(f_new):
            failures = 0
            g_norm = float(g_norm_new)
            reason = int(reason_new)
            w, f, g = w_trial, f_new, g_new
            tracker.record(f, f32(g_norm), w)
        else:
            failures += 1
            if it >= max_iter or failures >= max_improvement_failures:
                reason = MAX_ITERATIONS
    return OptResult(
        coefficients=w,
        value=f32(f).to(w.device),
        grad_norm=torch.linalg.norm(g),
        iterations=it,
        reason=reason,
        tracker=tracker.result(w),
    )
