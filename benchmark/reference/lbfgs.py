"""A plain L-BFGS for the references, with Photon ML's published rules
(LBFGS.scala's defaults over Breeze): the two-loop recursion over the last
``history`` pairs scaled by the newest pair's s.y / y.y; a pair kept only
where y.s > 1e-10; steepest descent where the direction does not descend;
a first trial step of 1 / max(|d|, 1) until a pair is kept, then 1;
Armijo backtracking (c1 = 1e-4, halving, at most 24 halvings, after which
the fit stops where it is); a stop when an iteration changes the value by
at most ``tolerance`` of the first value, when the gradient's norm falls
to ``tolerance`` of its first, or after ``max_iter`` iterations.

Every vector keeps the dtype that ``fg`` returns, so the same code runs
the float64 reference and the lower-precision control.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch

ARMIJO = 1e-4
MAX_HALVINGS = 24
CAUTIOUS = 1e-10


@dataclass
class Fit:
    w: torch.Tensor
    value: float
    iterations: int
    values: List[float]  # the value at the start and after each iteration
    first_grad_norm: float


def two_loop(g: torch.Tensor, s_list, y_list) -> torch.Tensor:
    q = g.clone()
    alphas = []
    for s, y in zip(reversed(s_list), reversed(y_list)):
        a = (s * q).sum() / (y * s).sum()
        q = q - a * y
        alphas.append(a)
    if s_list:
        s, y = s_list[-1], y_list[-1]
        q = q * ((s * y).sum() / (y * y).sum().clamp_min(1e-30))
    for (s, y), a in zip(zip(s_list, y_list), reversed(alphas)):
        b = (y * q).sum() / (y * s).sum()
        q = q + (a - b) * s
    return q


def minimize(
    fg: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    w0: torch.Tensor,
    *,
    max_iter: int,
    tolerance: float,
    history: int,
) -> Fit:
    """Minimize ``fg``'s value from ``w0`` (module note)."""
    w = w0.clone()
    f, g = fg(w)
    f0, g0 = float(f), float(g.norm())
    values = [f0]
    s_list, y_list = [], []
    it = 0
    while it < max_iter and g0 > 0:
        d = -two_loop(g, s_list, y_list)
        slope = float((g * d).sum())
        if not slope < 0:
            d = -g
            slope = -float((g * g).sum())
        t = 1.0 if s_list else 1.0 / max(float(d.norm()), 1.0)
        f_val = float(f)
        for _ in range(MAX_HALVINGS + 1):
            w_new = w + t * d
            f_new, g_new = fg(w_new)
            if float(f_new) <= f_val + ARMIJO * t * slope:
                break
            t *= 0.5
        else:
            break
        it += 1
        s, y = w_new - w, g_new - g
        if float((s * y).sum()) > CAUTIOUS:
            s_list.append(s)
            y_list.append(y)
            if len(s_list) > history:
                s_list.pop(0)
                y_list.pop(0)
        w, f, g = w_new, f_new, g_new
        values.append(float(f))
        if abs(f_val - float(f)) <= tolerance * abs(f0) or float(g.norm()) <= tolerance * g0:
            break
    return Fit(w, float(f), it, values, g0)
