"""Host-driven L-BFGS and OWL-QN for objectives whose evaluations run host
code (port of ``photon_ml_tpu/optim/host_lbfgs.py``): the streamed
objective (``io/streaming.py``) reads its chunk tiers on every
evaluation.

The math is the bank optimizers' (``optim/lbfgs.py``: two-loop recursion,
cautious memory updates at y.s <= 1e-10, steepest-descent fallback, Armijo
backtracking, the reference's convergence rules) for one vector, driven
from Python with the reference's readback discipline: only the scalars
that steer the host come back, batched through the counted
``overlap.device_get`` seam. Per iteration that is one fetch for the
direction's set-up, one per line-search trial and one for the convergence
batch (y.s, the gradient norm and the reason). The two-loop recursion
itself stays on the device.

The coefficients keep the dtype of ``w0`` (float32 on the card; the
tests run float64). As in the reference, the starting point is rounded to
float32 values (its ``jnp.asarray(w0, float32)``) and the convergence
test rounds the objective values to float32.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.optim.common import (
    GRADIENT_WITHIN_TOLERANCE,
    LINE_SEARCH_STALLED,
    NOT_CONVERGED,
    BoxConstraints,
    OptResult,
    Tracker,
    check_convergence,
)
from photon_ml_tpu_torch.optim.lbfgs import _pseudo_gradient
from photon_ml_tpu_torch.parallel import overlap

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]

_MEM_EPS = 1e-10  # the cautious-update threshold of optim/lbfgs.py


class HostTracker:
    """Per-iteration values, gradient norms and (``track``) coefficients,
    recorded on the host's schedule; :meth:`result` is the port's
    Tracker of one fit (``max_iter + 1`` slots)."""

    def __init__(self, capacity: int, track: bool):
        self.capacity = capacity
        self.values: List[float] = []
        self.grad_norms: List[float] = []
        self.coefs: Optional[List[Tensor]] = [] if track else None

    def record(self, value: float, grad_norm: float, w: Tensor) -> None:
        self.values.append(float(value))
        self.grad_norms.append(float(grad_norm))
        if self.coefs is not None:
            self.coefs.append(w)

    def result(self, like: Tensor) -> Tracker:
        n = len(self.values)
        values = like.new_zeros(self.capacity)
        grad_norms = like.new_zeros(self.capacity)
        values[:n] = torch.tensor(self.values, dtype=like.dtype)
        grad_norms[:n] = torch.tensor(self.grad_norms, dtype=like.dtype)
        coefs = None
        if self.coefs is not None:
            coefs = like.new_zeros(self.capacity, like.shape[0])
            coefs[:n] = torch.stack(self.coefs)
        return Tracker(values, grad_norms, n, coefs)


def f32(x) -> Tensor:
    """A host scalar (or tensor) rounded to float32, as the reference's
    ``jnp.float32`` casts in the convergence test."""
    return torch.as_tensor(x).to(torch.float32)


def start_point(w0: Tensor, box: Optional[BoxConstraints]) -> Tensor:
    """``w0`` rounded to float32 values in its own dtype, then boxed."""
    w = w0.to(torch.float32).to(w0.dtype)
    return w if box is None else box.project(w)


def converged(
    it, f_prev, f_new, g_norm: Tensor, f0, g0_norm, *, max_iter, tol, round_new: bool = True,
) -> Tensor:
    """The reason code of one fit (``check_convergence`` with the
    reference's float32 casts of the objective values; TRON's reference
    leaves the new value as it is: ``round_new=False``)."""
    dev = g_norm.device
    f_new = f32(f_new) if round_new else torch.as_tensor(f_new)
    return check_convergence(
        torch.tensor(it, device=dev), f32(f_prev).to(dev), f_new.to(dev), g_norm,
        f32(f0).to(dev), f32(g0_norm).to(dev), max_iter=max_iter, tol=tol,
    )


def _direction(g: Tensor, s_list: List[Tensor], y_list: List[Tensor]) -> Tensor:
    """Two-loop recursion over the (s, y) history: device scalars only
    (they feed arithmetic, never a branch)."""
    q = -g
    alphas = []
    rhos = [1.0 / torch.dot(y, s) for s, y in zip(s_list, y_list)]
    for s, y, rho in zip(reversed(s_list), reversed(y_list), reversed(rhos)):
        a = rho * torch.dot(s, q)
        q = q - a * y
        alphas.append((a, rho))
    if s_list:
        s, y = s_list[-1], y_list[-1]
        gamma = torch.dot(s, y) / torch.clamp_min(torch.dot(y, y), 1e-30)
        q = q * gamma
    for (a, rho), s, y in zip(reversed(alphas), s_list, y_list):
        b = rho * torch.dot(y, q)
        q = q + (a - b) * s
    return q


def _remember(s_list, y_list, s, y, ys: float, history: int) -> None:
    if ys > _MEM_EPS:  # cautious update
        s_list.append(s)
        y_list.append(y)
        if len(s_list) > history:
            s_list.pop(0)
            y_list.pop(0)


def minimize_lbfgs_host(
    value_and_grad_fn: ValueAndGrad,
    w0: Tensor,
    *,
    max_iter: int = 100,
    tol: float = 1e-7,
    history: int = 10,
    box: Optional[BoxConstraints] = None,
    ls_max_steps: int = 24,
    ls_c1: float = 1e-4,
    ls_shrink: float = 0.5,
    track_coefficients: bool = False,
) -> OptResult:
    """Minimize a smooth objective whose evaluations run host code; the
    defaults and convergence rules of ``optim.lbfgs.minimize_lbfgs``
    (LBFGS.scala:152-156, Optimizer.scala:156-170), with the hypercube
    projection of trial points (LBFGS.scala:77) under ``box``."""
    w = start_point(w0, box)
    f_dev, g = value_and_grad_fn(w)
    f, g0_norm = (float(v) for v in overlap.device_get((f_dev, torch.linalg.norm(g))))
    f0 = f
    g_norm = g0_norm
    tracker = HostTracker(max_iter + 1, track_coefficients)
    tracker.record(f, g0_norm, w)
    s_list: List[Tensor] = []
    y_list: List[Tensor] = []
    reason = GRADIENT_WITHIN_TOLERANCE if g0_norm == 0.0 else NOT_CONVERGED
    it = 0
    while reason == NOT_CONVERGED:
        d = _direction(g, s_list, y_list)
        # ONE fetch: the descent test, the Armijo slope and the first
        # step's scaling norm
        gd, d_norm = (
            float(v) for v in overlap.device_get((torch.dot(d, g), torch.linalg.norm(d)))
        )
        if gd >= 0:  # not a descent direction: steepest descent
            d = -g
            gd = -(g_norm * g_norm)
            d_norm = g_norm
        t = 1.0 if s_list else 1.0 / max(d_norm, 1.0)
        ok = False
        f_new, g_new, w_new = f, g, w
        for _ in range(ls_max_steps):
            w_t = w + t * d
            if box is not None:
                w_t = box.project(w_t)
            f_t, g_t = value_and_grad_fn(w_t)
            # one fetch per trial: the Armijo flag and the trial's value
            ok_t, f_t_host = overlap.device_get((
                (f_t <= f + ls_c1 * t * gd) & torch.isfinite(f_t), f_t,
            ))
            if bool(ok_t):
                ok = True
                w_new, f_new, g_new = w_t, float(f_t_host), g_t
                break
            t *= ls_shrink
        it += 1
        if not ok:
            # no decreasing step from here: a stalled search, not a cap
            reason = LINE_SEARCH_STALLED
            continue
        s = w_new - w
        y = g_new - g
        # the iteration's convergence batch in ONE fetch
        g_norm_new_dev = torch.linalg.norm(g_new)
        ys, g_norm_new, reason_new = overlap.device_get((
            torch.dot(y, s), g_norm_new_dev,
            converged(it, f, f_new, g_norm_new_dev, f0, g0_norm, max_iter=max_iter, tol=tol),
        ))
        _remember(s_list, y_list, s, y, float(ys), history)
        g_norm = float(g_norm_new)
        reason = int(reason_new)
        w, f, g = w_new, f_new, g_new
        tracker.record(f, g_norm, w)
    return OptResult(
        coefficients=w,
        value=f32(f).to(w.device),
        grad_norm=torch.linalg.norm(g),
        iterations=it,
        reason=reason,
        tracker=tracker.result(w),
    )


def minimize_owlqn_host(
    value_and_grad_fn: ValueAndGrad,
    w0: Tensor,
    l1_weight,
    *,
    max_iter: int = 100,
    tol: float = 1e-7,
    history: int = 10,
    l1_mask: Optional[Tensor] = None,
    box: Optional[BoxConstraints] = None,
    ls_max_steps: int = 24,
    ls_c1: float = 1e-4,
    ls_shrink: float = 0.5,
    track_coefficients: bool = False,
) -> OptResult:
    """Host-driven OWL-QN: minimize smooth(w) + l1 * ||l1_mask * w||_1
    (Andrew & Gao, as ``optim.lbfgs.minimize_owlqn``: pseudo-gradient,
    orthant-restricted direction, orthant projection of trial points and
    then the box, memory pairs on SMOOTH gradients) with the fetch
    discipline of :func:`minimize_lbfgs_host`. ``value_and_grad_fn``
    returns the smooth (value, gradient)."""
    w = start_point(w0, box)
    mask = torch.ones_like(w) if l1_mask is None else l1_mask.to(w)
    # the weight rounded to float32, as the reference's jnp.float32 cast
    l1_vec = f32(l1_weight).to(w.device) * mask

    def total_dev(w_t, f_smooth):
        return f_smooth + torch.sum(l1_vec * torch.abs(w_t))

    f_s, g = value_and_grad_fn(w)
    pg = _pseudo_gradient(w, g, l1_vec)
    f_tot, g0_norm = (
        float(v) for v in overlap.device_get((total_dev(w, f_s), torch.linalg.norm(pg)))
    )
    f0 = f_tot
    pg_norm = g0_norm
    tracker = HostTracker(max_iter + 1, track_coefficients)
    tracker.record(f32(f_tot), f32(g0_norm), w)
    s_list: List[Tensor] = []
    y_list: List[Tensor] = []
    reason = GRADIENT_WITHIN_TOLERANCE if g0_norm == 0.0 else NOT_CONVERGED
    it = 0
    while reason == NOT_CONVERGED:
        pg = _pseudo_gradient(w, g, l1_vec)
        d = _direction(pg, s_list, y_list)
        # restrict to the descent orthant of the pseudo-gradient
        d = torch.where(d * pg < 0, d, 0.0)
        dpg, d_norm = (
            float(v) for v in overlap.device_get((torch.dot(d, pg), torch.linalg.norm(d)))
        )
        if dpg >= 0:
            d = -pg
            d_norm = pg_norm
        orthant = torch.where(w != 0, torch.sign(w), torch.sign(-pg))
        t = 1.0 if s_list else 1.0 / max(d_norm, 1.0)
        ok = False
        w_new, f_new_tot, g_new = w, f_tot, g
        for _ in range(ls_max_steps):
            w_t = torch.where(torch.sign(w + t * d) == orthant, w + t * d, 0.0)
            if box is not None:
                # the box AFTER the orthant projection (LBFGS.scala:77)
                w_t = box.project(w_t)
            f_t_s, g_t = value_and_grad_fn(w_t)
            f_t_tot_dev = total_dev(w_t, f_t_s)
            # Armijo on the projected point against the pseudo-gradient:
            # one fetch per trial
            ok_t, f_t_tot = overlap.device_get((
                (f_t_tot_dev <= f_tot + ls_c1 * torch.dot(pg, w_t - w))
                & torch.isfinite(f_t_tot_dev),
                f_t_tot_dev,
            ))
            if bool(ok_t) and np.isfinite(float(f_t_tot)):
                ok = True
                w_new, f_new_tot, g_new = w_t, float(f_t_tot), g_t
                break
            t *= ls_shrink
        it += 1
        if not ok:
            reason = LINE_SEARCH_STALLED
            continue
        s = w_new - w
        y = g_new - g  # smooth gradients, per Andrew & Gao
        pg_norm_dev = torch.linalg.norm(_pseudo_gradient(w_new, g_new, l1_vec))
        ys, pg_norm_new, reason_new = overlap.device_get((
            torch.dot(y, s), pg_norm_dev,
            converged(it, f_tot, f_new_tot, pg_norm_dev, f0, g0_norm, max_iter=max_iter, tol=tol),
        ))
        _remember(s_list, y_list, s, y, float(ys), history)
        pg_norm = float(pg_norm_new)
        reason = int(reason_new)
        w, f_tot, g = w_new, f_new_tot, g_new
        tracker.record(f32(f_tot), f32(pg_norm), w)
    return OptResult(
        coefficients=w,
        value=f32(f_tot).to(w.device),
        grad_norm=torch.linalg.norm(_pseudo_gradient(w, g, l1_vec)),
        iterations=it,
        reason=reason,
        tracker=tracker.result(w),
    )
