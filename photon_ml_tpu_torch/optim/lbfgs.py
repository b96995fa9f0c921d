"""L-BFGS and OWL-QN (port of ``minimize_lbfgs`` and ``minimize_owlqn`` in
``photon_ml_tpu/optim/lbfgs.py``).

Reference: photon-ml .../optimization/LBFGS.scala (Breeze adapter, defaults
maxIter=100 m=10 tol=1e-7, box projection at :77) and OWLQN.scala:43-91
(L1 / elastic net). The optimizer is data-free: it sees only
``value_and_grad(w)``.

Both run over a coefficient bank ``[G, d]`` (the batched λ-grid; see
``optim/common.py`` for the freeze and fetch rules) or over one vector
``[d]``, which is a bank of one. The memory of (s, y) pairs is the
reference's ``[G, m, d]`` circular buffer with a length and a write slot
per member; the cautious update (skip pairs with y.s <= 1e-10) differs per
member. Which members keep their pair rides in the per-trip fetch, so
the host knows every member's length and slot, and the pair is stored
after the fetch. While
the members agree (one fit always, a bank until a member freezes or skips
a pair), the memory is read and written through views of one slot;
otherwise each member's slot is gathered, and the two-loop recursion
masks invalid slots to exact zeros, as the reference does. Both give the
same direction. Line search is projected Armijo backtracking. Each outer
trip makes one host fetch for the whole bank, plus one per line-search
trial.

OWL-QN (Andrew & Gao): pseudo-gradient, direction restricted to its
descent orthant, trial points projected onto the orthant and then into the
box; memory pairs use smooth gradients. ``l1_weight`` is per member,
times ``l1_mask`` (the intercept is exempt).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from photon_ml_tpu_torch.optim.common import (
    GRADIENT_WITHIN_TOLERANCE,
    LINE_SEARCH_STALLED,
    NOT_CONVERGED,
    BoxConstraints,
    MeshReductions,
    OptResult,
    Tracker,
    ValueAndGrad,
    as_bank_of_one,
    backtracking_line_search,
    check_convergence,
    dot,
    dots,
    feature_sum,
    fetch,
    norm,
    select,
)

Tensor = torch.Tensor


@dataclass
class _Memory:
    """Circular buffer of (s, y, rho) per member, updated in place; each
    member's count of valid pairs and next write slot live on the host."""

    s: Tensor  # [G, m, d]
    y: Tensor  # [G, m, d]
    rho: Tensor  # [G, m]
    length: List[int]
    ptr: List[int]

    @classmethod
    def empty(cls, G: int, m: int, d: int, like: Tensor) -> "_Memory":
        return cls(
            like.new_zeros(G, m, d), like.new_zeros(G, m, d), like.new_zeros(G, m),
            [0] * G, [0] * G,
        )

    def uniform(self) -> bool:
        """Every member holds as many pairs, ending at the same slot."""
        return len(set(zip(self.length, self.ptr))) == 1

    def on_device(self, values: List[int]) -> Tensor:
        """A host list as an int64 [G] tensor (after the trip's fetch the
        device has little queued, so the copy waits on little)."""
        return torch.tensor(values, dtype=torch.int64, device=self.s.device)

    def push(self, s: Tensor, y: Tensor, rho: Tensor, keep: Tensor, kept: List[float]):
        """Cautious update: store member g's pair where ``keep`` holds
        (y.s > 1e-10, keeps H~ positive definite, and the member is
        active); ``kept`` is ``keep`` as the host fetched it."""
        m = self.rho.shape[1]
        if not any(kept):
            return
        if self.uniform():
            p = self.ptr[0]
            every = all(kept)
            self.s[:, p] = select(keep, s, self.s[:, p], every)
            self.y[:, p] = select(keep, y, self.y[:, p], every)
            self.rho[:, p] = select(keep, rho, self.rho[:, p], every)
        else:
            slot = (torch.arange(s.shape[0], device=s.device), self.on_device(self.ptr))
            self.s[slot] = select(keep, s, self.s[slot])
            self.y[slot] = select(keep, y, self.y[slot])
            self.rho[slot] = select(keep, rho, self.rho[slot])
        self.length = [min(n + 1, m) if k else n for n, k in zip(self.length, kept)]
        self.ptr = [(p + 1) % m if k else p for p, k in zip(self.ptr, kept)]


def _two_loop_direction(
    g: Tensor, mem: _Memory, mesh: Optional[MeshReductions] = None
) -> Tensor:
    """Two-loop recursion over each member's circular buffer; -> -H~ g."""
    m = mem.rho.shape[1]
    if mem.uniform():
        # every member's pairs sit in the same slots: views, no masks
        n, p = mem.length[0], mem.ptr[0]
        slots = [(p - 1 - i) % m for i in range(n)]  # newest first
        alphas = []
        q = g
        for k in slots:
            a = mem.rho[:, k] * dot(mem.s[:, k], q, mesh)
            q = q - a[:, None] * mem.y[:, k]
            alphas.append(a)
        r = q
        if n:
            s_l, y_l = mem.s[:, slots[0]], mem.y[:, slots[0]]
            sy, yy = dots((s_l, y_l), (y_l, y_l), mesh=mesh)
            r = (sy / torch.clamp_min(yy, 1e-30))[:, None] * q
        for k, a in zip(reversed(slots), reversed(alphas)):
            b = mem.rho[:, k] * dot(mem.y[:, k], r, mesh)
            r = r + (a - b)[:, None] * mem.s[:, k]
        return -r
    # Slots past a member's length contribute exact zeros; slots past the
    # longest member's length are skipped.
    G = g.shape[0]
    rows = torch.arange(G, device=g.device)
    length, ptr = mem.on_device(mem.length), mem.on_device(mem.ptr)
    alphas = g.new_zeros(G, m)
    q = g
    for i in range(max(mem.length)):
        idx = (ptr - 1 - i) % m
        valid = i < length
        a = torch.where(
            valid, mem.rho[rows, idx] * dot(mem.s[rows, idx], q, mesh), 0.0
        )
        q = q - a[:, None] * mem.y[rows, idx]
        alphas[rows, idx] = a
    last = (ptr - 1) % m
    s_l, y_l = mem.s[rows, last], mem.y[rows, last]
    sy, yy = dots((s_l, y_l), (y_l, y_l), mesh=mesh)
    gamma = torch.where(length > 0, sy / torch.clamp_min(yy, 1e-30), 1.0)
    r = gamma[:, None] * q
    for i in range(max(mem.length)):
        idx = (ptr - length + i) % m
        valid = i < length
        b = torch.where(
            valid, mem.rho[rows, idx] * dot(mem.y[rows, idx], r, mesh), 0.0
        )
        r = r + torch.where(valid, alphas[rows, idx] - b, 0.0)[:, None] * mem.s[rows, idx]
    return -r


def _pseudo_gradient(w: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """Andrew & Gao pseudo-gradient of f(w) + l1 * ||w||_1."""
    right = g + l1
    left = g - l1
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, 0.0))
    return torch.where(w > 0, right, torch.where(w < 0, left, at_zero))


def minimize_lbfgs(
    value_and_grad_fn: ValueAndGrad,
    w0: Tensor,
    *,
    max_iter: int = 100,
    tol: float = 1e-7,
    history: int = 10,
    box: Optional[BoxConstraints] = None,
    ls_max_steps: int = 24,
    mesh: Optional[MeshReductions] = None,
    track_coefficients: bool = False,
) -> OptResult:
    """Minimize a smooth objective (defaults: LBFGS.scala:152-156). ``w0``
    is [d], or a bank [G, d] whose ``value_and_grad_fn`` maps [G, d] ->
    ([G], [G, d]). ``mesh``: this rank's reductions when ``w0`` is its
    feature block (or a replica) on a mesh of ranks (``optim/common.py``).
    ``track_coefficients``: keep every iterate in ``result.tracker.coefs``
    (slot 0 the initial point)."""
    return _minimize_qn(
        value_and_grad_fn, w0, None, None, max_iter=max_iter, tol=tol,
        history=history, box=box, ls_max_steps=ls_max_steps, mesh=mesh,
        track_coefficients=track_coefficients,
    )


def minimize_owlqn(
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
    mesh: Optional[MeshReductions] = None,
    track_coefficients: bool = False,
) -> OptResult:
    """Minimize smooth(w) + l1_weight * ||l1_mask * w||_1 (OWL-QN).

    ``l1_weight`` is a scalar or, for a bank, one weight per member [G];
    ``l1_mask`` [d] exempts slots (the intercept) from the penalty.
    ``box``: every trial point is projected into it AFTER the orthant
    projection (the reference's OWLQN inherits LBFGS's projection,
    OWLQN.scala:43-91, LBFGS.scala:77). The result's ``value`` is the
    total objective and ``grad_norm`` the pseudo-gradient's norm. ``mesh``
    and ``track_coefficients`` as for :func:`minimize_lbfgs` (``l1_mask``
    is then this rank's block)."""
    return _minimize_qn(
        value_and_grad_fn, w0, l1_weight, l1_mask, max_iter=max_iter, tol=tol,
        history=history, box=box, ls_max_steps=ls_max_steps, mesh=mesh,
        track_coefficients=track_coefficients,
    )


def _minimize_qn(
    vg, w0, l1_weight, l1_mask, *, max_iter, tol, history, box, ls_max_steps,
    mesh, track_coefficients,
) -> OptResult:
    if w0.dim() == 1:
        if l1_weight is not None:
            l1_weight = torch.as_tensor(l1_weight, dtype=w0.dtype).reshape(1)
        return _minimize_qn(
            as_bank_of_one(vg), w0[None], l1_weight, l1_mask, max_iter=max_iter,
            tol=tol, history=history, box=box, ls_max_steps=ls_max_steps,
            mesh=mesh, track_coefficients=track_coefficients,
        ).member(0)
    G, d = w0.shape
    owl = l1_weight is not None
    w = w0 if box is None else box.project(w0)
    f, g = vg(w)  # f: the smooth value
    if owl:
        l1 = torch.as_tensor(l1_weight, dtype=w.dtype, device=w.device)
        mask = w.new_ones(d) if l1_mask is None else l1_mask.to(w)
        l1_vec = l1.reshape(-1, 1).expand(G, 1) * mask

        def penalty(w_):
            return feature_sum(l1_vec * w_.abs(), mesh)

        f0 = f + penalty(w)
        g0_norm = norm(_pseudo_gradient(w, g, l1_vec), mesh)
    else:
        f0, g0_norm = f, norm(g, mesh)
    tracker = Tracker.start(
        f0, g0_norm, max_iter + 1, w if track_coefficients else None
    )
    mem = _Memory.empty(G, history, d, w)
    reason = torch.where(g0_norm == 0.0, GRADIENT_WITHIN_TOLERANCE, NOT_CONVERGED)
    it = torch.zeros(G, dtype=torch.int64, device=w.device)
    (reasons,) = fetch(reason, mesh=mesh)
    iters = [0] * G
    trip = 0
    while NOT_CONVERGED in reasons:
        active = reason == NOT_CONVERGED
        every = all(r == NOT_CONVERGED for r in reasons)  # known on the host
        trip += 1
        if owl:
            pg = _pseudo_gradient(w, g, l1_vec)
            direction = _two_loop_direction(pg, mem, mesh)
            # restrict the direction to the descent orthant of the
            # pseudo-gradient
            direction = torch.where(direction * pg < 0, direction, 0.0)
            orthant = torch.where(w != 0, torch.sign(w), torch.sign(-pg))

            def project(w_t, orthant=orthant):
                w_t = torch.where(torch.sign(w_t) == orthant, w_t, 0.0)
                return w_t if box is None else box.project(w_t)

            def ls_vg(w_t):
                fs, gs = vg(w_t)
                return fs + penalty(w_t), gs  # total value, SMOOTH gradient

            f_cur, slope = f + penalty(w), pg
        else:
            direction = _two_loop_direction(g, mem, mesh)
            # steepest descent when d is not a descent direction
            direction = select(dot(direction, g, mesh) < 0, direction, -g)
            project = None if box is None else box.project
            ls_vg, f_cur, slope = vg, f, g
        # a unit first step once a member has pairs (rho > 0 marks them)
        if all(mem.length):
            t0 = direction.new_ones(G)
        else:
            t0 = torch.where(
                (mem.rho > 0).any(dim=1), 1.0,
                1.0 / torch.clamp_min(norm(direction, mesh), 1.0),
            )
        ls = backtracking_line_search(
            ls_vg, w, f_cur, slope, direction, t0, active, every=every,
            max_steps=ls_max_steps, project=project, mesh=mesh,
        )
        s_k, y_k = ls.w - w, ls.g - g
        ys = dot(y_k, s_k, mesh)
        keep = (ys > 1e-10) & active
        if owl:
            f_new = ls.f - penalty(ls.w)
            g_norm = norm(_pseudo_gradient(ls.w, ls.g, l1_vec), mesh)
        else:
            f_new, g_norm = ls.f, norm(ls.g, mesh)
        it = select(active, it + 1, it, every)
        # a failed search is reported before the function-change test (a
        # stalled search has delta f == 0 and would look converged)
        code = torch.where(
            ls.ok,
            check_convergence(
                it, f_cur, ls.f, g_norm, f0, g0_norm, max_iter=max_iter, tol=tol
            ),
            LINE_SEARCH_STALLED,
        )
        w = select(active, ls.w, w, every)
        f = select(active, f_new, f, every)
        g = select(active, ls.g, g, every)
        reason = select(active, code, reason, every)
        tracker.record(trip, active, ls.f, g_norm, every, coef=ls.w)
        iters = [n + (r == NOT_CONVERGED) for n, r in zip(iters, reasons)]
        reasons, kept = fetch(reason, keep, mesh=mesh)
        mem.push(s_k, y_k, 1.0 / torch.clamp_min(ys, 1e-30), keep, kept)
    tracker.count = [n + 1 for n in iters]
    if owl:
        value, grad_norm = f + penalty(w), norm(_pseudo_gradient(w, g, l1_vec), mesh)
    else:
        value, grad_norm = f, norm(g, mesh)
    return OptResult(
        coefficients=w, value=value, grad_norm=grad_norm, iterations=iters,
        reason=[int(r) for r in reasons], tracker=tracker,
    )
