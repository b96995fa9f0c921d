"""L-BFGS (port of ``minimize_lbfgs`` in ``photon_ml_tpu/optim/lbfgs.py``).

Reference: photon-ml .../optimization/LBFGS.scala (Breeze adapter, defaults
maxIter=100 m=10 tol=1e-7, box projection at :77). The optimizer is
data-free: it sees only ``value_and_grad(w)``.

The reference's ``lax.while_loop`` becomes a Python loop over device
tensors. The memory of (s, y) pairs is a host-side deque of device
vectors; its length is known on the host, so the two-loop recursion runs
over the valid pairs only (the reference masks invalid slots to exact
zeros, which is the same arithmetic). Line search is projected Armijo
backtracking with cautious memory updates (pairs with y.s <= 1e-10 are
skipped). Each iteration makes one host fetch for its control scalars, plus
one per line-search trial.

OWL-QN (L1 / elastic net) is not ported yet.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import torch

from photon_ml_tpu_torch.optim.common import (
    GRADIENT_WITHIN_TOLERANCE,
    LINE_SEARCH_STALLED,
    NOT_CONVERGED,
    BoxConstraints,
    OptResult,
    Tracker,
    ValueAndGrad,
    backtracking_line_search,
    check_convergence,
    fetch,
)

Tensor = torch.Tensor


def _two_loop_direction(g: Tensor, memory: deque) -> Tensor:
    """Classic two-loop recursion over the (s, y, rho) pairs, oldest first;
    returns -H~ g."""
    q = g
    alphas = []
    for s, y, rho in reversed(memory):
        a = rho * torch.dot(s, q)
        q = q - a * y
        alphas.append(a)
    if memory:
        s, y, _ = memory[-1]
        gamma = torch.dot(s, y) / torch.clamp_min(torch.dot(y, y), 1e-30)
    else:
        gamma = 1.0
    r = gamma * q
    for (s, y, rho), a in zip(memory, reversed(alphas)):
        b = rho * torch.dot(y, r)
        r = r + (a - b) * s
    return -r


def minimize_lbfgs(
    value_and_grad_fn: ValueAndGrad,
    w0: Tensor,
    *,
    max_iter: int = 100,
    tol: float = 1e-7,
    history: int = 10,
    box: Optional[BoxConstraints] = None,
    ls_max_steps: int = 24,
) -> OptResult:
    """Minimize a smooth objective (defaults: LBFGS.scala:152-156)."""
    project = box.project if box is not None else None
    w = w0 if project is None else project(w0)
    f, g = value_and_grad_fn(w)
    f0 = f
    g0_norm = torch.linalg.vector_norm(g)
    tracker = Tracker()
    tracker.record(f0, g0_norm)
    memory: deque = deque(maxlen=history)
    (zero_grad,) = fetch(g0_norm == 0.0)
    reason = GRADIENT_WITHIN_TOLERANCE if zero_grad else NOT_CONVERGED
    iteration = 0
    while reason == NOT_CONVERGED:
        d = _two_loop_direction(g, memory)
        # steepest descent when d is not a descent direction
        d = torch.where(torch.dot(d, g) < 0, d, -g)
        if memory:
            t0 = torch.ones((), dtype=f.dtype, device=f.device)
        else:
            t0 = 1.0 / torch.clamp_min(torch.linalg.vector_norm(d), 1.0)
        ls = backtracking_line_search(
            value_and_grad_fn, w, f, g, d, t0,
            max_steps=ls_max_steps, project=project,
        )
        s, y = ls.w - w, ls.g - g
        ys = torch.dot(y, s)
        iteration += 1
        g_norm = torch.linalg.vector_norm(ls.g)
        code = check_convergence(
            iteration, f, ls.f, g_norm, f0, g0_norm, max_iter=max_iter, tol=tol
        )
        keep_pair, code = fetch(ys > 1e-10, code)
        if keep_pair:
            memory.append((s, y, 1.0 / torch.clamp_min(ys, 1e-30)))
        # a failed search is reported before the function-change test (a
        # stalled search has delta f == 0 and would look converged)
        reason = int(code) if ls.ok else LINE_SEARCH_STALLED
        w, f, g = ls.w, ls.f, ls.g
        tracker.record(f, g_norm)
    return OptResult(
        coefficients=w,
        value=f,
        grad_norm=torch.linalg.vector_norm(g),
        iterations=iteration,
        reason=reason,
        tracker=tracker,
    )
