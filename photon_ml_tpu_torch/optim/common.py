"""Shared optimizer machinery: convergence, line search, tracking,
projection (port of ``photon_ml_tpu/optim/common.py``).

Reference: photon-ml .../optimization/Optimizer.scala (convergence checks
at 156-170), OptimizationStatesTracker.scala, OptimizationUtils.

The reference runs its optimizers as ``lax.while_loop`` programs and
``jax.vmap``s them over a ``[G, d]`` coefficient bank for the batched
λ-grid. Here the loop is Python over tensors that stay on the device, and
every optimizer runs over a bank: ``G`` members side by side, each with
its own state, step sizes and stop reason (one fit is a bank of one). The
host reads only what decides control flow, for the whole bank in one copy
made by :func:`fetch`. ``host_fetches`` counts those copies: one per
line-search trial, one per CG step and one per outer trip, so the count
follows the slowest member and not G.

On a mesh of ranks (``parallel/mesh.py``) the optimizers take a
:class:`MeshReductions` (the reference's ``axis_name``). With the
coefficients sharded by feature block, every inner product, norm and sum
over the feature axis is a member-wise partial plus one all-reduce of a
``[G]`` vector over the model group. And on any mesh, sharded or
replicated, every rank must take the same branch, or the next collective
hangs: so one fetch serves every rank too. It broadcasts world rank 0's
flags in the same fetch: one collective of the few ``float64`` flags,
staged through the host like the copy itself, and counted on
``collectives`` beside ``host_fetches``. With four gloo ranks sharing one
H100 a fetch took 0.4-0.6 ms alone and 1.2-1.5 ms with its broadcast
(``chip_smoke.py`` phase 6, ``mesh_collective_us``). Without a mesh every
function here is the single-card code.

Freeze (the batching rule of ``lax.while_loop``): a member whose reason is
no longer NOT_CONVERGED keeps its state bit for bit while the others go
on; every update is a ``torch.where`` on the ``[G]`` active mask, skipped
where the host already knows that the mask holds for every member (one
fit always, until it stops), since it would return the new state as it
is.

Convergence reasons mirror the reference's:
  MAX_ITERATIONS, FUNCTION_VALUES_WITHIN_TOLERANCE (|f_k - f_{k-1}| <=
  tol |f_0|), GRADIENT_WITHIN_TOLERANCE (||g_k|| <= tol ||g_0||) and
  LINE_SEARCH_STALLED (no decreasing step found).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from photon_ml_tpu_torch.ops.kernels import entity_products
from photon_ml_tpu_torch.parallel.multihost import gather_in_rank_order

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
# Collectives over process groups (all_reduce, all_gather_last and the
# flag broadcast in fetch); a run sets it to 0 and reads it.
collectives = 0


@dataclass(frozen=True)
class MeshReductions:
    """Where an optimizer's reductions go on a mesh of ranks.

    ``model``: the group whose ranks hold the other feature blocks of the
    coefficients; inner products, norms and sums over the feature axis are
    summed over it. None when every rank holds the whole vector (the
    data-parallel fit). ``world``: every rank of the mesh; each fetch
    hands world rank 0's flags to all of them."""

    model: Optional[object]
    world: object


def all_reduce(t: Tensor, group) -> Tensor:
    """Sum ``t`` over the ranks of ``group``, in place (``t`` must be a
    contiguous tensor the caller owns); counted. -> ``t``."""
    global collectives
    collectives += 1
    dist.all_reduce(t, group=group)
    return t


def sum_over(group, *parts: Tensor, scalars: int = 0) -> List[Tensor]:
    """Each part summed over the ranks of ``group`` in ONE all-reduce (the
    reference's ``psum`` of a tuple). The first ``scalars`` parts are one
    value per member (``[]`` or ``[G]``), the others vectors ``[..., k]``."""
    cols = [p[..., None] for p in parts[:scalars]] + list(parts[scalars:])
    flat = all_reduce(torch.cat(cols, dim=-1), group)
    out = flat.split([c.shape[-1] for c in cols], dim=-1)
    return [o[..., 0] for o in out[:scalars]] + list(out[scalars:])


def all_gather_last(t: Tensor, group) -> Tensor:
    """Each rank's ``t`` [..., k] concatenated along the last axis in the
    group's rank order -> [..., n * k]; counted."""
    global collectives
    collectives += 1
    return torch.cat(list(gather_in_rank_order(t, group)), dim=-1)


def fetch(*tensors: Tensor, mesh: Optional[MeshReductions] = None) -> List:
    """Copy a few small tensors to the host in ONE transfer; counted.
    -> a float for each 0-d tensor, a list for each 1-d one. On a mesh
    every rank gets world rank 0's values (one counted broadcast)."""
    global host_fetches, collectives
    host_fetches += 1
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    if mesh is not None:
        collectives += 1
        dist.broadcast(flat, src=dist.get_global_rank(mesh.world, 0), group=mesh.world)
    flat = flat.tolist()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i] if t.dim() == 0 else flat[i:i + n])
        i += n
    return out


def _sharded(mesh: Optional[MeshReductions]) -> bool:
    return mesh is not None and mesh.model is not None


def dot(a: Tensor, b: Tensor, mesh: Optional[MeshReductions] = None) -> Tensor:
    """Member-wise inner product of two banks [G, d] -> [G] (over every
    feature block on a sharded mesh), each member in ``row_sum``'s order
    of additions (``ops/kernels/entity_products.py``): a member's bits do
    not depend on how many members share the bank."""
    out = entity_products.row_dot(a, b)
    return all_reduce(out, mesh.model) if _sharded(mesh) else out


def dots(*pairs, mesh: Optional[MeshReductions] = None) -> List[Tensor]:
    """:func:`dot` of each pair, the pairs of one shape in one launch on
    the card (``entity_products.row_dots``); on a sharded mesh the
    partials share ONE all-reduce."""
    parts = entity_products.row_dots(pairs)
    if _sharded(mesh):
        parts = all_reduce(parts, mesh.model)
    return list(parts.unbind(0))


def norm(a: Tensor, mesh: Optional[MeshReductions] = None) -> Tensor:
    """Member-wise Euclidean norm [G, d] -> [G]."""
    if not _sharded(mesh):
        return entity_products.row_norm(a)
    return torch.sqrt(torch.clamp_min(dot(a, a, mesh), 0.0))


def feature_sum(a: Tensor, mesh: Optional[MeshReductions] = None) -> Tensor:
    """Member-wise sum over the feature axis [G, d] -> [G], in
    ``row_sum``'s order."""
    out = entity_products.row_dot(a)
    return all_reduce(out, mesh.model) if _sharded(mesh) else out


def select(mask: Tensor, new: Tensor, old: Tensor, every: bool = False) -> Tensor:
    """``new`` where the [G] mask holds, else ``old``, for [G] or [G, ...]
    state (the per-member carry select of a batched while_loop).
    ``every``: the host knows the mask holds for every member, so ``new``
    is the result and no kernel runs."""
    if every:
        return new
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def as_bank_of_one(fn: Callable) -> Callable:
    """A function of single vectors as a function of banks of one member:
    what lets one fit run through the bank optimizers."""

    def bank_fn(*banks):
        out = fn(*(b[0] for b in banks))
        return tuple(o[None] for o in out) if isinstance(out, tuple) else out[None]

    return bank_fn


@dataclass(frozen=True)
class BoxConstraints:
    """Per-coefficient [lower, upper] box; +-inf for unconstrained."""

    lower: Tensor
    upper: Tensor

    def project(self, w: Tensor) -> Tensor:
        return torch.clamp(w, self.lower, self.upper)


def project_coefficients_to_hypercube(w: Tensor, box: Optional[BoxConstraints]) -> Tensor:
    """``w`` clipped to ``box`` (OptimizationUtils'
    projectCoefficientsToHypercube); unchanged without one."""
    return w if box is None else box.project(w)


@dataclass
class Tracker:
    """Per-iteration trace: slot i holds the value and gradient norm of
    iteration i (slot 0 the initial point) and ``count`` the filled slots.
    A bank's tracker has a leading grid axis and a count per member.

    ``coefs`` (the reference's ``track_coefficients``, its ModelTracker
    analog) is a buffer preallocated on the device, ``[G, cap, d]`` for a
    bank: slot i holds the coefficients of iteration i. None unless the
    optimizer was asked to track them. Writing it is a device copy per
    trip and no host fetch."""

    values: Tensor  # [cap] or [G, cap]
    grad_norms: Tensor  # [cap] or [G, cap]
    count: Union[int, List[int]]
    coefs: Optional[Tensor] = None  # [cap, d] or [G, cap, d]

    @classmethod
    def start(
        cls, value: Tensor, grad_norm: Tensor, capacity: int,
        coef: Optional[Tensor] = None,
    ) -> "Tracker":
        """Slot 0 of every member; ``coef`` ([G, d]) starts the coefficient
        buffer when tracking."""
        values = value.new_zeros(value.shape + (capacity,))
        grad_norms = grad_norm.new_zeros(grad_norm.shape + (capacity,))
        values[..., 0] = value
        grad_norms[..., 0] = grad_norm
        coefs = None
        if coef is not None:
            coefs = coef.new_zeros(coef.shape[:-1] + (capacity, coef.shape[-1]))
            coefs[:, 0] = coef
        return cls(values, grad_norms, [1] * value.shape[0], coefs)

    def record(
        self, trip: int, active: Tensor, value: Tensor, grad_norm: Tensor,
        every: bool = False, coef: Optional[Tensor] = None,
    ):
        """Write slot ``trip`` of the active members (every active member
        has made exactly ``trip`` iterations); the host keeps the counts.
        ``every`` as for :func:`select`; ``coef`` [G, d] is written when
        the tracker holds coefficients. A frozen member's slots stay as
        they are."""
        i = min(trip, self.values.shape[-1] - 1)
        self.values[:, i] = select(active, value, self.values[:, i], every)
        self.grad_norms[:, i] = select(active, grad_norm, self.grad_norms[:, i], every)
        if self.coefs is not None:
            self.coefs[:, i] = select(active, coef, self.coefs[:, i], every)


@dataclass
class OptResult:
    """Result of one optimize() call: one fit (``iterations`` and
    ``reason`` ints) or a bank (tensors with a leading grid axis, and
    lists of ints); :meth:`member` takes one fit out of a bank."""

    coefficients: Tensor
    value: Tensor
    grad_norm: Tensor
    iterations: Union[int, List[int]]
    reason: Union[int, List[int]]
    tracker: Tracker

    @property
    def reason_name(self) -> Union[str, List[str]]:
        """The reason's name; a list of them for a bank."""
        if isinstance(self.reason, list):
            return [CONVERGENCE_REASON_NAMES.get(r, "?") for r in self.reason]
        return CONVERGENCE_REASON_NAMES.get(self.reason, "?")

    def member(self, i: int) -> "OptResult":
        t = self.tracker
        return OptResult(
            coefficients=self.coefficients[i],
            value=self.value[i],
            grad_norm=self.grad_norm[i],
            iterations=self.iterations[i],
            reason=self.reason[i],
            tracker=Tracker(
                t.values[i], t.grad_norms[i], t.count[i],
                None if t.coefs is None else t.coefs[i],
            ),
        )


def check_convergence(
    iteration: Tensor,
    f_prev: Tensor,
    f_cur: Tensor,
    g_norm: Tensor,
    f0: Tensor,
    g0_norm: Tensor,
    *,
    max_iter: int,
    tol: float,
) -> Tensor:
    """Convergence-reason code per member (0 if not converged), on the
    device; relative tests against each member's initial state and its own
    iteration count (Optimizer.scala:156-170)."""
    reason = torch.where(
        torch.abs(f_cur - f_prev) <= tol * torch.abs(f0),
        FUNCTION_VALUES_WITHIN_TOLERANCE,
        NOT_CONVERGED,
    )
    reason = torch.where(g_norm <= tol * g0_norm, GRADIENT_WITHIN_TOLERANCE, reason)
    return torch.where(
        (reason == NOT_CONVERGED) & (iteration >= max_iter), MAX_ITERATIONS, reason
    )


ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]


@dataclass
class LineSearchResult:
    step: Tensor  # [G]
    w: Tensor
    f: Tensor
    g: Tensor
    ok: Tensor  # [G] bool: sufficient decrease achieved


def backtracking_line_search(
    vg: ValueAndGrad,
    w: Tensor,
    f: Tensor,
    g: Tensor,
    direction: Tensor,
    t0: Tensor,
    searching: Tensor,
    *,
    every: bool = False,
    c1: float = 1e-4,
    shrink: float = 0.5,
    max_steps: int = 24,
    project: Optional[Callable[[Tensor], Tensor]] = None,
    mesh: Optional[MeshReductions] = None,
) -> LineSearchResult:
    """Armijo backtracking over a bank, projecting each trial point.

    Each member in ``searching`` backtracks only while its own test fails;
    the others keep their first trial untouched. Every trial evaluates the
    whole bank once and makes one host fetch of the [G] flags. A member
    that finds no decreasing step keeps its original point (``ok`` False).
    ``every``: the host knows that every member is searching. ``mesh``:
    see :class:`MeshReductions`.
    """

    def trial(t):
        w_t = w + t[:, None] * direction
        if project is not None:
            w_t = project(w_t)
        f_t, g_t = vg(w_t)
        return w_t, f_t, g_t

    def armijo_ok(w_t, f_t):
        return (f_t <= f + c1 * dot(g, w_t - w, mesh)) & torch.isfinite(f_t)

    t = t0
    w_t, f_t, g_t = trial(t)
    ok = armijo_ok(w_t, f_t)
    need = searching & ~ok
    (need_host,) = fetch(need, mesh=mesh)
    k = 0
    while any(need_host) and k < max_steps:
        all_need = all(need_host)
        t = select(need, t * shrink, t, all_need)
        w_n, f_n, g_n = trial(t)
        w_t = select(need, w_n, w_t, all_need)
        f_t = select(need, f_n, f_t, all_need)
        g_t = select(need, g_n, g_t, all_need)
        ok = armijo_ok(w_t, f_t)
        need = searching & ~ok
        (need_host,) = fetch(need, mesh=mesh)
        k += 1
    all_ok = every and not any(need_host)
    return LineSearchResult(
        step=t, w=select(ok, w_t, w, all_ok), f=select(ok, f_t, f, all_ok),
        g=select(ok, g_t, g, all_ok), ok=ok,
    )
