"""Plain reference for the logistic GLM cells.

The objective of a λ is F(w) = sum_i log(1 + exp(z_i)) - y_i z_i + λ/2 |w|^2
with z_i = x_i . w + o_i over the generated rows (every coefficient, the
intercept too, under the L2 term, as the program's L2 objective). It is
computed from the generator's arrays alone with plain PyTorch
(``sparse.py``), and minimized by the plain L-BFGS of ``lbfgs.py``. It
imports nothing of the program.

``dtype`` is the precision the values and vectors are kept in and
``acc`` the one sums are taken in: float64 / float64 for the reference,
bfloat16 / float32 for the control (``fit``), which keeps bfloat16 data
and vectors and adds in float32, as a lower-precision program would.

A fit of 100 L-BFGS iterations stops far from the optimum at the small
λs of a grid, so the check does not hold a model to the optimum. It
follows each λ's fit from the start the program had (zero, or on the
warm-started path the program's model of the λ before) through its
first ``FOLLOW`` iterations in float64, and judges (``judge``).
``FOLLOW`` is the history of 10 pairs and two more, so the followed
iterations take in the first that overwrites a pair and the first whose
direction reads a wrapped history:

- ``loss_gap``: the program's objective at its start and after each of
  those iterations (its tracker's values) against the reference's,
  relative, the largest over the λs and fits judged;
- ``grad_gap``: the gradient's norm at the start, likewise;
- ``value_gap``: the objective value the program reported for its
  returned model against the float64 objective at that model, relative,
  the largest: the whole fit's answer, through its last iteration.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from reference import lbfgs
from reference.sparse import SparseRows

FOLLOW = 12


class Rows:
    """The generated rows on the device in ``dtype``: ``sparse`` (X) and
    ``labels``."""

    def __init__(self, data: dict, features: int, device, dtype=torch.float64,
                 idx_key="feats", val_key="vals"):
        idx = torch.as_tensor(data[idx_key]).to(device=device, dtype=torch.int64)
        val = torch.as_tensor(data[val_key]).to(device=device)
        self.sparse = SparseRows(idx, val, features, dtype)
        self.labels = torch.as_tensor(data["labels"]).to(device=device, dtype=dtype)
        self.features = int(features)
        self.dtype = dtype
        self.device = self.labels.device


def value_grad(rows: Rows, w: torch.Tensor, lam: float, acc=torch.float64,
               offsets: Optional[torch.Tensor] = None):
    """(F(w), gradient) in ``w``'s dtype, sums in ``acc``."""
    dtype = w.dtype
    z = rows.sparse.matvec(w, acc)
    if offsets is not None:
        z = z + offsets.to(acc)
    z = z.to(dtype)
    y = rows.labels.to(dtype)
    f = (torch.nn.functional.softplus(z) - y * z).sum(dtype=acc)
    g = rows.sparse.rmatvec(torch.sigmoid(z) - y, acc)
    wa = w.to(acc)
    return (f + 0.5 * lam * (wa * wa).sum()).to(dtype), (g + lam * wa).to(dtype)


def minimize(rows: Rows, lam: float, start: torch.Tensor, *, max_iter: int, tolerance: float,
             history: int, acc=torch.float64, offsets=None) -> lbfgs.Fit:
    return lbfgs.minimize(
        lambda v: value_grad(rows, v, lam, acc, offsets), start.to(rows.device, rows.dtype),
        max_iter=max_iter, tolerance=tolerance, history=history,
    )


def fit(rows: Rows, lambdas: List[float], *, warm_start: bool, max_iter: int,
        tolerance: float, history: int, acc=torch.float32) -> Dict[float, dict]:
    """The reference's own fit of every λ (descending; each from the last
    λ's model where ``warm_start``, else from zero) in ``rows.dtype`` with
    the program's optimizer settings, read as ``judge`` reads a program's
    fit. The control runs it in bfloat16."""
    out = {}
    w = torch.zeros(rows.features, dtype=rows.dtype, device=rows.device)
    for lam in sorted(lambdas, reverse=True):
        start = w if warm_start else torch.zeros_like(w)
        r = minimize(rows, lam, start, max_iter=max_iter, tolerance=tolerance,
                     history=history, acc=acc)
        out[lam] = {"start": start, "w": r.w, "reported": r.value,
                    "values": r.values[:FOLLOW + 1], "first_grad_norm": r.first_grad_norm}
        w = r.w
    return out


def judge(rows: Rows, fits: List[Dict[float, dict]], history: int,
          detail: Optional[list] = None) -> Dict[str, float]:
    """``fits``: a list of grid fits, each {λ: {"start", "w", "reported",
    "values", "first_grad_norm"}}; -> the numbers the check compares
    (module note). ``detail`` collects each λ's readings."""
    loss_gap = grad_gap = value_gap = 0.0
    for grid in fits:
        for lam, m in grid.items():
            ref = minimize(rows, lam, m["start"], max_iter=FOLLOW, tolerance=0.0, history=history)
            steps = min(len(ref.values), len(m["values"]))
            gaps = [abs(float(m["values"][i]) - ref.values[i]) / abs(ref.values[i])
                    for i in range(steps)]
            g_gap = abs(float(m["first_grad_norm"]) - ref.first_grad_norm) / ref.first_grad_norm
            f = float(value_grad(rows, m["w"].to(rows.device, torch.float64), lam)[0])
            v_gap = abs(float(m["reported"]) - f) / abs(f)
            loss_gap = max(loss_gap, *gaps)
            grad_gap, value_gap = max(grad_gap, g_gap), max(value_gap, v_gap)
            if detail is not None:
                detail.append({"lambda": lam, "loss_gaps": gaps, "grad_gap": g_gap,
                               "value_gap": v_gap, "ref_values": ref.values})
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "value_gap": value_gap}
