"""TRON: trust-region Newton with truncated conjugate gradient (port of
``photon_ml_tpu/optim/tron.py``).

Reference: photon-ml .../optimization/TRON.scala (LIBLINEAR port: outer
trust-region loop with eta/sigma rules at 103-256, truncated CG with one
Hessian-vector product per step, <= 20 CG steps, defaults maxIter=15
tol=1e-5).

The reference's two ``lax.while_loop``s become Python loops over device
tensors, run over a coefficient bank ``[G, d]`` (the batched λ-grid; one
fit is a bank of one; see ``optim/common.py`` for the freeze and fetch
rules). Both loops are masked per member: a member's CG stops on its own
test while the others go on. Each CG step makes one host fetch (the
continue flags of the whole bank) and each outer trip one more (the
convergence codes). Given ``hvp_fn(w, d)``, the Hessian-vector product
recomputes z(w) in every CG step, as the reference's ``hvp_fn`` does;
given ``hvp_factory(w)``, the w-only pieces are computed once per outer
trip (on a mesh that also saves their all-reduce per CG step).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.optim.common import (
    GRADIENT_WITHIN_TOLERANCE,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    BoxConstraints,
    MeshReductions,
    OptResult,
    Tracker,
    ValueAndGrad,
    as_bank_of_one,
    check_convergence,
    dot,
    dots,
    fetch,
    norm,
    select,
)

Tensor = torch.Tensor

# LIBLINEAR trust-region constants (TRON.scala / tron.cpp).
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0

HvpFactory = Callable[[Tensor], Callable[[Tensor], Tensor]]


def _truncated_cg(
    hvp: Callable[[Tensor], Tensor],
    g: Tensor,
    delta: Tensor,
    active: Tensor,
    *,
    max_cg: int,
    cg_tol_factor: float = 0.1,
    mesh: Optional[MeshReductions] = None,
):
    """Steihaug truncated CG for each active member: approximately solve
    H s = -g, ||s|| <= delta (TRON.scala:259-341). Returns ``(s, r)`` with
    r = -g - H s kept through boundary exits."""
    cg_tol = cg_tol_factor * norm(g, mesh)
    r = -g
    s = torch.zeros_like(g)
    d = r
    rtr = dot(r, r, mesh)
    done = ~active
    iters = 0
    while iters < max_cg:
        go = ~done & (torch.sqrt(rtr) > cg_tol)
        (go_host,) = fetch(go, mesh=mesh)
        if not any(go_host):
            break
        hd = hvp(d)
        # d.Hd and the boundary step's three products share one reduction
        dhd, dd, sd, ss = dots((d, hd), (d, d), (s, d), (s, s), mesh=mesh)
        # negative curvature or radius hit: walk to the boundary and stop
        alpha = rtr / torch.where(dhd > 0, dhd, torch.ones_like(dhd))
        hit = (norm(s + alpha[:, None] * d, mesh) >= delta) | (dhd <= 0)
        rad = torch.sqrt(torch.clamp_min(sd * sd + dd * (delta * delta - ss), 0.0))
        tau = (-sd + rad) / torch.clamp_min(dd, 1e-30)
        step = torch.where(hit, tau, alpha)
        s_new = s + step[:, None] * d
        r_new = r - step[:, None] * hd
        rtr_new = dot(r_new, r_new, mesh)
        beta = rtr_new / torch.clamp_min(rtr, 1e-30)
        d_new = select(hit, d, r_new + beta[:, None] * d)
        every = all(go_host)
        s, r = select(go, s_new, s, every), select(go, r_new, r, every)
        d, rtr = select(go, d_new, d, every), select(go, rtr_new, rtr, every)
        done = done | (go & hit)
        iters += 1
    return s, r


def _bank_of_one_factory(factory: HvpFactory) -> HvpFactory:
    def bank_factory(w_bank: Tensor):
        hvp = factory(w_bank[0])
        return lambda d_bank: hvp(d_bank[0])[None]

    return bank_factory


def minimize_tron(
    value_and_grad_fn: ValueAndGrad,
    hvp_fn: Optional[Callable[[Tensor, Tensor], Tensor]],
    w0: Tensor,
    *,
    max_iter: int = 15,
    tol: float = 1e-5,
    max_cg: int = 20,
    max_improvement_failures: int = 16,
    box: Optional[BoxConstraints] = None,
    hvp_factory: Optional[HvpFactory] = None,
    mesh: Optional[MeshReductions] = None,
    track_coefficients: bool = False,
) -> OptResult:
    """Trust-region Newton; ``hvp_fn(w, d) -> H(w) @ d``, or
    ``hvp_factory(w) -> (d -> H(w) @ d)``, which computes the w-only pieces
    once per outer trip (``hvp_fn`` is then ignored; pass None)
    (defaults: TRON.scala:260-265). ``w0`` is [d], or a bank [G, d] whose
    functions map banks to banks. ``mesh`` and ``track_coefficients`` as
    for ``minimize_lbfgs``."""
    if w0.dim() == 1:
        return minimize_tron(
            as_bank_of_one(value_and_grad_fn),
            None if hvp_factory is not None else as_bank_of_one(hvp_fn),
            w0[None], max_iter=max_iter, tol=tol, max_cg=max_cg,
            max_improvement_failures=max_improvement_failures, box=box,
            hvp_factory=(
                None if hvp_factory is None else _bank_of_one_factory(hvp_factory)
            ),
            mesh=mesh, track_coefficients=track_coefficients,
        ).member(0)
    G = w0.shape[0]
    w = w0 if box is None else box.project(w0)
    f, g = value_and_grad_fn(w)
    f0 = f
    g0_norm = norm(g, mesh)
    delta = g0_norm
    tracker = Tracker.start(
        f0, g0_norm, max_iter + 1, w if track_coefficients else None
    )
    reason = torch.where(g0_norm == 0.0, GRADIENT_WITHIN_TOLERANCE, NOT_CONVERGED)
    failures = torch.zeros(G, dtype=torch.int64, device=w.device)
    it = torch.zeros_like(failures)
    (reasons,) = fetch(reason, mesh=mesh)
    iters = [0] * G
    trip = 0
    while NOT_CONVERGED in reasons:
        active = reason == NOT_CONVERGED
        every = all(r_ == NOT_CONVERGED for r_ in reasons)
        trip += 1
        w_cur = w
        hvp = (
            hvp_factory(w_cur) if hvp_factory is not None
            else (lambda d: hvp_fn(w_cur, d))
        )
        s, r = _truncated_cg(hvp, g, delta, active, max_cg=max_cg, mesh=mesh)
        w_trial = w + s
        if box is not None:
            w_trial = box.project(w_trial)
            s = w_trial - w
        f_new, g_new = value_and_grad_fn(w_trial)
        gs, sr = dots((g, s), (s, r), mesh=mesh)
        # r = -g - H s, so prered = -(g.s + 0.5 s.Hs) = -0.5 (g.s - s.r)
        prered = -0.5 * (gs - sr)
        actred = f - f_new
        snorm = norm(s, mesh)

        # step-size estimate for the radius update (tron.cpp alpha rule)
        denom = f_new - f - gs
        alpha = torch.where(
            denom <= 0, _SIGMA3, torch.clamp_min(-0.5 * (gs / denom), _SIGMA1)
        )
        a_s = alpha * snorm
        delta_new = torch.where(
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

        accept = (actred > _ETA0 * prered) & torch.isfinite(f_new)
        w2 = select(accept, w_trial, w)
        f2 = torch.where(accept, f_new, f)
        g2 = select(accept, g_new, g)
        failures_new = torch.where(accept, 0, failures + 1)
        it_new = it + 1
        g_norm = norm(g2, mesh)
        code = check_convergence(
            it_new, f, f2, g_norm, f0, g0_norm, max_iter=max_iter, tol=tol
        )
        # rejected steps must not trip the function-change test
        code = torch.where(
            accept, code,
            torch.where(it_new >= max_iter, MAX_ITERATIONS, NOT_CONVERGED),
        )
        code = torch.where(
            (code == NOT_CONVERGED) & (failures_new >= max_improvement_failures),
            MAX_ITERATIONS, code,
        )
        w = select(active, w2, w, every)
        f = select(active, f2, f, every)
        g = select(active, g2, g, every)
        delta = select(active, delta_new, delta, every)
        failures = select(active, failures_new, failures, every)
        it = select(active, it_new, it, every)
        reason = select(active, code, reason, every)
        tracker.record(trip, active, f2, g_norm, every, coef=w2)
        iters = [n + (r_ == NOT_CONVERGED) for n, r_ in zip(iters, reasons)]
        (reasons,) = fetch(reason, mesh=mesh)
    tracker.count = [n + 1 for n in iters]
    return OptResult(
        coefficients=w,
        value=f,
        grad_norm=norm(g, mesh),
        iterations=iters,
        reason=[int(r_) for r_ in reasons],
        tracker=tracker,
    )
