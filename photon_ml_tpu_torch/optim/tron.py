"""TRON: trust-region Newton with truncated conjugate gradient (port of
``photon_ml_tpu/optim/tron.py``).

Reference: photon-ml .../optimization/TRON.scala (LIBLINEAR port: outer
trust-region loop with eta/sigma rules at 103-256, truncated CG with one
Hessian-vector product per step, <= 20 CG steps, defaults maxIter=15
tol=1e-5).

The reference's two ``lax.while_loop``s become Python loops over device
tensors. Each CG step makes one host fetch (its continue test) and each
outer iteration one more (the convergence code).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.optim.common import (
    GRADIENT_WITHIN_TOLERANCE,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    BoxConstraints,
    OptResult,
    Tracker,
    ValueAndGrad,
    check_convergence,
    fetch,
)

Tensor = torch.Tensor

# LIBLINEAR trust-region constants (TRON.scala / tron.cpp).
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


def _truncated_cg(
    hvp: Callable[[Tensor], Tensor],
    g: Tensor,
    delta: Tensor,
    *,
    max_cg: int,
    cg_tol_factor: float = 0.1,
):
    """Steihaug truncated CG: approximately solve H s = -g, ||s|| <= delta
    (TRON.scala:259-341). Returns ``(s, r)`` with r = -g - H s kept through
    boundary exits."""
    norm = torch.linalg.vector_norm
    cg_tol = cg_tol_factor * norm(g)

    def boundary_tau(s, d):
        dd = torch.dot(d, d)
        sd = torch.dot(s, d)
        ss = torch.dot(s, s)
        rad = torch.sqrt(torch.clamp_min(sd * sd + dd * (delta * delta - ss), 0.0))
        return (-sd + rad) / torch.clamp_min(dd, 1e-30)

    r = -g
    s = torch.zeros_like(g)
    d = r
    rtr = torch.dot(r, r)
    done = torch.zeros((), dtype=torch.bool, device=g.device)
    iters = 0
    while iters < max_cg:
        (go,) = fetch(~done & (torch.sqrt(rtr) > cg_tol))
        if not go:
            break
        hd = hvp(d)
        dhd = torch.dot(d, hd)
        # negative curvature or radius hit: walk to the boundary and stop
        alpha = rtr / torch.where(dhd > 0, dhd, torch.ones_like(dhd))
        hit = (norm(s + alpha * d) >= delta) | (dhd <= 0)
        step = torch.where(hit, boundary_tau(s, d), alpha)
        s = s + step * d
        r_new = r - step * hd
        rtr_new = torch.dot(r_new, r_new)
        beta = rtr_new / torch.clamp_min(rtr, 1e-30)
        d = torch.where(hit, d, r_new + beta * d)
        r, rtr, done = r_new, rtr_new, done | hit
        iters += 1
    return s, r


def minimize_tron(
    value_and_grad_fn: ValueAndGrad,
    hvp_fn: Callable[[Tensor, Tensor], Tensor],
    w0: Tensor,
    *,
    max_iter: int = 15,
    tol: float = 1e-5,
    max_cg: int = 20,
    max_improvement_failures: int = 16,
    box: Optional[BoxConstraints] = None,
) -> OptResult:
    """Trust-region Newton; ``hvp_fn(w, d) -> H(w) @ d``
    (defaults: TRON.scala:260-265)."""
    norm = torch.linalg.vector_norm
    w = w0 if box is None else box.project(w0)
    f, g = value_and_grad_fn(w)
    f0 = f
    g0_norm = norm(g)
    delta = g0_norm
    tracker = Tracker()
    tracker.record(f0, g0_norm)
    (zero_grad,) = fetch(g0_norm == 0.0)
    reason = GRADIENT_WITHIN_TOLERANCE if zero_grad else NOT_CONVERGED
    failures = 0
    iteration = 0
    while reason == NOT_CONVERGED:
        w_cur = w
        s, r = _truncated_cg(
            lambda d: hvp_fn(w_cur, d), g, delta, max_cg=max_cg
        )
        w_trial = w + s
        if box is not None:
            w_trial = box.project(w_trial)
            s = w_trial - w
        f_new, g_new = value_and_grad_fn(w_trial)
        gs = torch.dot(g, s)
        # r = -g - H s, so prered = -(g.s + 0.5 s.Hs) = -0.5 (g.s - s.r)
        prered = -0.5 * (gs - torch.dot(s, r))
        actred = f - f_new
        snorm = norm(s)

        # step-size estimate for the radius update (tron.cpp alpha rule)
        denom = f_new - f - gs
        alpha = torch.where(
            denom <= 0,
            torch.full_like(denom, _SIGMA3),
            torch.clamp_min(-0.5 * (gs / denom), _SIGMA1),
        )
        a_s = alpha * snorm
        delta = torch.where(
            actred < _ETA0 * prered,
            torch.minimum(torch.clamp_min(alpha, _SIGMA1) * snorm, _SIGMA2 * delta),
            torch.where(
                actred < _ETA1 * prered,
                torch.maximum(_SIGMA1 * delta, torch.minimum(a_s, _SIGMA2 * delta)),
                torch.where(
                    actred < _ETA2 * prered,
                    torch.maximum(_SIGMA1 * delta, torch.minimum(a_s, _SIGMA3 * delta)),
                    torch.maximum(delta, torch.minimum(a_s, _SIGMA3 * delta)),
                ),
            ),
        )

        accept_t = (actred > _ETA0 * prered) & torch.isfinite(f_new)
        w = torch.where(accept_t, w_trial, w)
        f2 = torch.where(accept_t, f_new, f)
        g = torch.where(accept_t, g_new, g)
        iteration += 1
        g_norm = norm(g)
        code = check_convergence(
            iteration, f, f2, g_norm, f0, g0_norm, max_iter=max_iter, tol=tol
        )
        accept, code = fetch(accept_t, code)
        f = f2
        failures = 0 if accept else failures + 1
        if accept:
            reason = int(code)
        else:
            # rejected steps must not trip the function-change test
            reason = MAX_ITERATIONS if iteration >= max_iter else NOT_CONVERGED
        if reason == NOT_CONVERGED and failures >= max_improvement_failures:
            reason = MAX_ITERATIONS
        tracker.record(f, g_norm)
    return OptResult(
        coefficients=w,
        value=f,
        grad_norm=norm(g),
        iterations=iteration,
        reason=reason,
        tracker=tracker,
    )
