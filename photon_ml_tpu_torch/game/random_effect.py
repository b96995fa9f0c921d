"""Random-effect solver: per-entity GLM solves over coefficient banks (port
of the single-device parts of ``photon_ml_tpu/game/random_effect.py``).

Reference: photon-ml .../algorithm/RandomEffectCoordinate.scala:104-128 —
``activeData.join(optimizationProblems).join(modelsRDD).mapValues { local
optimizer.optimize }`` i.e. millions of independent single-node solves —
and optimization/game/RandomEffectOptimizationProblem.scala:41-130 (one
problem per entity) with tracker aggregation
(RandomEffectOptimizationTracker.scala).

A bucket of E equal-capacity entities is one ``[E, D]`` bank, and the
reference's ``jax.vmap(minimize_*)`` becomes the port's bank optimizers
(``optim/lbfgs.py``, ``optim/tron.py``): every member keeps its own line
search, convergence and freeze, and the host reads one flag vector per
trial for the whole bucket. The per-entity objective is batched: a
``gather`` for the margins, a ``scatter_add_`` for the gradient. The dense
layouts densify each entity's rows into ``X [E, S, D]`` by an indexed
``scatter_add_`` (the reference's compare-and-reduce ``_densify``, a TPU
answer to serialized scatters). The dual-space Newton solver is a host
loop over the whole bucket: one fetch per Newton iteration, converged
entities frozen bit for bit.

Every per-entity product and sum (the Gram, the batched matvecs, the
values, margins and norms, and the optimizers' member-wise dots) goes
through ``ops/kernels/entity_products.py``: on the card a kernel that
adds in ``data/batch.py`` ``row_sum``'s order, on the CPU PyTorch's own
operators. Either way an entity's row, iterations and stop reason depend
on its own data alone, not on how many entities share its bucket or the
padding beside it, so a shard block of the hash-sharded bank
(``game/pod.py``) solves each entity to the bits of its bucket.

With a ``mesh`` (this rank's ``parallel.mesh.ProcessMesh``) the bank stays
whole on every rank, and every bucket's entity axis is split over the
mesh's first axis: a rank solves only its contiguous slice of each bucket
(the reference's expert-parallel sharding, padded to ``n_dev * E_loc``),
its offsets arrive through ``residual_routing.ResidualRouter``'s one
all-to-all, and the solved rows come back to every rank by an all-gather
in rank order. The hash-sharded bank is ``game/pod.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.game.random_effect_data import RandomEffectDataset
from photon_ml_tpu_torch.ops import fixed_order
from photon_ml_tpu_torch.ops.kernels import entity_products
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.optim import common
from photon_ml_tpu_torch.optim.common import (
    CONVERGENCE_REASON_NAMES,
    FUNCTION_VALUES_WITHIN_TOLERANCE,
    GRADIENT_WITHIN_TOLERANCE,
    LINE_SEARCH_STALLED,
    NOT_CONVERGED,
    check_convergence,
)
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
)
from photon_ml_tpu_torch.optim.lbfgs import minimize_lbfgs, minimize_owlqn
from photon_ml_tpu_torch.optim.problem import _VARIANCE_EPSILON
from photon_ml_tpu_torch.optim.tron import minimize_tron
from photon_ml_tpu_torch.parallel.overlap import Deferred

Tensor = torch.Tensor

_N_REASONS = max(CONVERGENCE_REASON_NAMES) + 1


@dataclass
class RandomEffectTracker:
    """Aggregated per-entity convergence stats
    (RandomEffectOptimizationTracker analog)."""

    num_entities: int
    iterations_mean: float
    iterations_max: int
    reason_counts: Dict[str, int]


class LazyRandomEffectTracker:
    """RandomEffectTracker whose stats stay on the device until first use:
    ``update_bank(..., defer_tracker=True)`` returns one of these. The CD
    loop fetches its ``deferred`` with the objective in one batched
    readback (``overlap.fetch_all``); otherwise the first attribute read
    makes the one fetch."""

    __slots__ = ("deferred",)

    def __init__(self, deferred: Deferred):
        self.deferred = deferred

    def _tracker(self) -> RandomEffectTracker:
        return self.deferred.result()

    @property
    def num_entities(self) -> int:
        return self._tracker().num_entities

    @property
    def iterations_mean(self) -> float:
        return self._tracker().iterations_mean

    @property
    def iterations_max(self) -> int:
        return self._tracker().iterations_max

    @property
    def reason_counts(self) -> Dict[str, int]:
        return self._tracker().reason_counts

    def __repr__(self) -> str:
        return repr(self._tracker())


def densify(ix: Tensor, v: Tensor, d_local: int) -> Tensor:
    """Each entity's sparse rows ``[E, S, k]`` as a dense ``X [E, S, D]``:
    an indexed scatter-add, so duplicate indices in a row sum and padding
    (index 0, value 0) adds zero; in a fixed order on the card
    (``ops/fixed_order.py``)."""
    E, S, _ = ix.shape
    return fixed_order.scatter_add_rows(v.new_zeros(E, S, d_local), ix, v)


def densify_compare(ix: Tensor, v: Tensor, d_local: int, chunk: int = 1024) -> Tensor:
    """The reference's compare-and-reduce densification (``_densify``,
    ``photon_ml_tpu/game/random_effect.py:193-204``) in plain torch, over
    ``chunk`` entities at a time; the yardstick :func:`densify` is held
    to."""
    d = torch.arange(d_local, device=ix.device, dtype=ix.dtype)
    out = []
    for s in range(0, ix.shape[0], chunk):
        i, x = ix[s:s + chunk], v[s:s + chunk]
        out.append((x[..., None] * (i[..., None] == d)).sum(dim=2))
    return torch.cat(out) if out else v.new_zeros(0, ix.shape[1], d_local)


def _bmv(A: Tensor, x: Tensor) -> Tensor:
    """Batched matrix-vector product [E, m, n] x [E, n] -> [E, m], per
    entity in a fixed order (module note)."""
    return entity_products.bmv(A, x)


def _lanes(l2):
    """``l2`` as (per-lane value, per-lane column): a float twice, or a
    ``[E]`` tensor (one weight a lane, the unified grid's members folded
    into the batch) and its ``[E, 1]`` column."""
    if torch.is_tensor(l2):
        return l2, l2[:, None]
    return l2, l2


def _sparse_objective(loss: PointwiseLoss, ix, v, lab, off, w, l2):
    """(vg, hvp, hdiag) of every entity of a bucket at once, over the
    bucket's sparse rows (the reference's ``entity_objective`` under
    ``vmap``): margins by gather, gradients by scatter-add. ``l2``: a
    float, or one weight a lane (``[E]``)."""
    E, S, k = ix.shape
    flat = ix.reshape(E, S * k)
    l2, l2c = _lanes(l2)

    def margins(c):
        return _dot(v, torch.gather(c, 1, flat).view(E, S, k))

    def scatter(c_like, rows):
        return fixed_order.scatter_add_rows(
            torch.zeros_like(c_like), flat, rows.reshape(E, S * k)
        )

    def vg(c):
        z = margins(c) + off
        val = _dot(w, loss.value(z, lab)) + 0.5 * l2 * _dot(c, c)
        grad = scatter(c, v * (w * loss.d1(z, lab))[..., None]) + l2c * c
        return val, grad

    def hvp(c, d):
        z = margins(c) + off
        cd = w * loss.d2(z, lab) * margins(d)
        return scatter(c, v * cd[..., None]) + l2c * d

    def hdiag(c):
        z = margins(c) + off
        return scatter(c, (v * v) * (w * loss.d2(z, lab))[..., None]) + l2c

    return vg, hvp, hdiag


def _dense_objective(loss: PointwiseLoss, X, lab, off, w, l2):
    """(vg, hvp) over dense per-entity blocks X [E, S, D]."""
    Xt = X.transpose(1, 2)
    l2, l2c = _lanes(l2)

    def vg(c):
        z = _bmv(X, c) + off
        val = _dot(w, loss.value(z, lab)) + 0.5 * l2 * _dot(c, c)
        return val, _bmv(Xt, w * loss.d1(z, lab)) + l2c * c

    def hvp(c, d):
        z = _bmv(X, c) + off
        return _bmv(Xt, w * loss.d2(z, lab) * _bmv(X, d)) + l2c * d

    return vg, hvp


def _dot(a: Tensor, b: Tensor) -> Tensor:
    """Per-entity inner product over the last axis, in a fixed order."""
    return entity_products.row_dot(a, b)


def newton_solve(
    loss: PointwiseLoss, X: Tensor, lab: Tensor, off: Tensor, w: Tensor,
    bank: Tensor, l2: float, *, max_iter: int, tol: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Damped Newton in the dual (sample) space for every entity of a bucket
    (the reference's ``solve_dense_newton``, ``:241-430``).

    With the sample Gram G = X X^T ([S, S], built once), the Newton step
    is H^-1 g = (g - X^T (l2 I + D G)^-1 D X g) / l2 by Woodbury; the
    ``[S, S]`` system is solved by CG for exactly S iterations on the
    symmetrized B = l2 I + Dh G Dh. A 16-trial halving line search (8
    along the Newton step, 8 along the exact Cauchy step) runs in z-space;
    when no trial decreases, an entity on its optimum's float plateau
    stops as converged, else as stalled. A host loop replaces the
    ``while_loop``: one fetch per Newton iteration for the whole bucket,
    converged entities frozen. -> (coefficients, iterations, reasons)."""
    E, S, _ = X.shape
    Xt = X.transpose(1, 2)
    G = entity_products.gram(X)
    l2, l2c = _lanes(l2)

    def value(c, z):
        return _dot(w, loss.value(z, lab)) + 0.5 * l2 * _dot(c, c)

    def grad_vec(z, c):
        return _bmv(Xt, w * loss.d1(z, lab)) + l2c * c

    c = bank
    z = _bmv(X, c) + off
    f0 = value(c, z)
    g = grad_vec(z, c)
    g0_norm = entity_products.row_norm(g)
    f = f0
    reason = torch.where(g0_norm == 0.0, GRADIENT_WITHIN_TOLERANCE, NOT_CONVERGED)
    it = torch.zeros(E, dtype=torch.int64, device=X.device)
    (reasons,) = common.fetch(reason)
    while NOT_CONVERGED in reasons:
        every = all(r == NOT_CONVERGED for r in reasons)
        active = reason == NOT_CONVERGED
        cd = w * loss.d1(z, lab)
        d2 = w * loss.d2(z, lab)
        zp = z - off
        u = _bmv(G, cd) + l2c * zp  # = X g, no X pass
        dh = torch.sqrt(d2)
        rhs = dh * u
        x = torch.zeros_like(rhs)
        r, p, rs = rhs, rhs, _dot(rhs, rhs)
        for _ in range(S):
            ap = l2c * p + dh * _bmv(G, dh * p)
            alpha = rs / (_dot(p, ap) + 1e-30)
            x = x + alpha[:, None] * p
            r = r - alpha[:, None] * ap
            rs2 = _dot(r, r)
            p = r + (rs2 / (rs + 1e-30))[:, None] * p
            rs = rs2
        t = dh * x
        rr = cd - t
        step = -_bmv(Xt, rr) / l2c - c  # = -H^-1 g, one X pass
        z_step = -_bmv(G, rr) / l2c - zp  # = X step, dual space

        cc = _dot(c, c)
        cs_n, ss_n = _dot(c, step), _dot(step, step)
        cg_dot, g_sq = _dot(c, g), _dot(g, g)
        g_hg = _dot(u, d2 * u) + l2 * g_sq
        cauchy = g_sq / (g_hg + 1e-30)
        cs_c, ss_c = -cauchy * cg_dot, cauchy * cauchy * g_sq
        z_step_c = -cauchy[:, None] * u

        # the 16 trials of the reference's while_loop, all evaluated: an
        # entity takes the first that decreases (k), and f_min is the
        # running minimum of the trials it evaluated (0..k)
        done = torch.zeros(E, dtype=torch.bool, device=X.device)
        k = torch.full((E,), 16, dtype=torch.int64, device=X.device)
        alpha_t = torch.full_like(f, 2.0 ** -8)
        f_t = torch.full_like(f, float("inf"))
        f_min = None
        for j in range(16):
            newton = j < 8
            a = 2.0 ** -(j if newton else j - 8)
            z_j = z + a * (z_step if newton else z_step_c)
            cs, ss = (cs_n, ss_n) if newton else (cs_c, ss_c)
            f_j = _dot(w, loss.value(z_j, lab)) + 0.5 * l2 * (
                cc + 2.0 * a * cs + a * a * ss
            )
            f_min = f_j if f_min is None else torch.where(
                done, f_min, torch.minimum(f_min, f_j)
            )
            good = (f_j <= f) & torch.isfinite(f_j) & ~done
            k = torch.where(good, j, k)
            alpha_t = torch.where(good, a, alpha_t)
            f_t = torch.where(good, f_j, f_t)
            done = done | good
        moved = (f_t <= f) & torch.isfinite(f_t)
        plateau = ~moved & (f_min <= f + 1e-6 * (1.0 + torch.abs(f)))
        newton_used = (k < 8)[:, None]
        used_step = torch.where(newton_used, step, -cauchy[:, None] * g)
        used_zstep = torch.where(newton_used, z_step, z_step_c)
        m = moved[:, None]
        c2 = torch.where(m, c + alpha_t[:, None] * used_step, c)
        z2 = torch.where(m, z + alpha_t[:, None] * used_zstep, z)
        f2 = torch.where(moved, f_t, f)
        it2 = it + 1
        g2 = grad_vec(z2, c2)
        g_norm = entity_products.row_norm(g2)
        code = torch.where(
            moved,
            check_convergence(it2, f, f2, g_norm, f0, g0_norm, max_iter=max_iter, tol=tol),
            torch.where(plateau, FUNCTION_VALUES_WITHIN_TOLERANCE, LINE_SEARCH_STALLED),
        )
        c = common.select(active, c2, c, every)
        z = common.select(active, z2, z, every)
        f = common.select(active, f2, f, every)
        g = common.select(active, g2, g, every)
        it = common.select(active, it2, it, every)
        reason = common.select(active, code, reason, every)
        (reasons,) = common.fetch(reason)
    return c, it, reason


@dataclass
class RandomEffectOptimizationProblem:
    """One solver config shared by all entities (the reference materializes
    an RDD of identical per-entity problems; here the per-entity state is
    just the bank row).

    ``layout``: "auto" densifies a bucket's ``[E, S, k]`` rows into
    ``[E, S, D]`` blocks when they fit ``dense_bytes_budget`` (and then
    takes the dual-space Newton solver when the problem allows it);
    "sparse" / "dense" force a layout. ``mesh``: every bucket's entity
    axis is split over the mesh's first axis (see the module docstring);
    every rank of the mesh calls with the same arguments and gets the
    same bank."""

    loss: PointwiseLoss
    config: OptimizerConfig
    regularization: RegularizationContext
    reg_weight: float = 0.0
    mesh: Optional[object] = None
    layout: str = "auto"
    dense_bytes_budget: int = 2 << 30
    # isComputingVariance (RandomEffectOptimizationProblem.scala:106-127)
    compute_variances: bool = False

    def __post_init__(self):
        if self.layout not in ("auto", "sparse", "dense"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.mesh is not None and not hasattr(self.mesh, "axis_names"):
            raise TypeError(
                f"mesh must be a parallel.mesh.ProcessMesh, got {type(self.mesh).__name__}"
            )

    # -- solver selection ----------------------------------------------------

    def _bucket_kind(self, bucket, d_local: int) -> str:
        """Which solver a bucket runs: sparse | dense | newton, with an
        ``_id`` suffix when the bucket's indices are the tiled arange."""
        use_dense = self._use_dense(bucket, d_local)
        kind = (
            ("newton" if self._newton_eligible() else "dense")
            if use_dense
            else "sparse"
        )
        if use_dense and bucket.identity_indices:
            kind += "_id"
        return kind

    def _newton_eligible(self) -> bool:
        """The dual-space Newton solver needs l2 > 0 (Woodbury ridge), a
        twice-differentiable loss, and no l1/TRON machinery."""
        l1, l2 = self.regularization.split(self.reg_weight)
        return (
            l2 > 0.0
            and not l1
            and self.loss.has_hessian
            and self.config.optimizer_type != OptimizerType.TRON
        )

    def _use_dense(self, bucket, d_local: int) -> bool:
        """X [E, S, D] (none for identity indices), plus the Newton path's
        Gram [E, S, S] when that solver would run, within the budget at
        the values' itemsize."""
        if self.layout != "auto":
            return self.layout == "dense"
        e_b, s_b, _ = bucket.indices.shape
        itemsize = np.dtype(bucket.values.dtype).itemsize
        floats = 0 if bucket.identity_indices else e_b * s_b * d_local
        if self._newton_eligible():
            floats += e_b * s_b * s_b
        return floats * itemsize <= self.dense_bytes_budget

    # -- device staging ----------------------------------------------------------

    def _bucket_device_args(self, bucket, device, with_values: bool = True) -> Tuple[Tensor, ...]:
        """(indices, values, labels, weights, offsets, row index, entity
        codes) of a bucket on ``device``, uploaded once and kept on the
        bucket itself, so they die with it; indices are int64 for
        gather / scatter. ``with_values=False`` (the ``values_override``
        path) uploads no values and gives None in their place: a caller
        that always overrides them must not pin a dead copy."""
        cache = bucket.__dict__.setdefault("_device_args", {})
        key = (device, with_values)
        hit = cache.get(key)
        if hit is None:
            def up(a, dtype=None):
                t = torch.as_tensor(a, device=device)
                return t if dtype is None else t.to(dtype)

            hit = (
                up(bucket.indices, torch.int64),
                up(bucket.values) if with_values else None,
                up(bucket.labels), up(bucket.weights), up(bucket.offsets),
                up(bucket.row_index, torch.int64),
                up(bucket.entity_codes, torch.int64),
            )
            cache[key] = hit
        return hit

    def prewarm(self, specs) -> None:
        """Check (bank, dataset, has_values_override,
        has_residual_offsets) quadruples ahead of their first update. The
        reference compiles every bucket's program of all of them here, in
        one thread pool (the MF coordinate calls it before its first ALS
        half-step); a torch solve has nothing to compile, so this only
        checks that each bank matches its dataset."""
        for bank, dataset, _, _ in specs:
            if tuple(bank.shape) != (dataset.num_entities, dataset.local_dim):
                raise ValueError(
                    f"bank {tuple(bank.shape)} does not match the dataset's "
                    f"[{dataset.num_entities}, {dataset.local_dim}]"
                )

    # -- solves ------------------------------------------------------------------

    def _solve(self, kind: str, sl: Tensor, ix, v, lab, off, w, l1: float, l2: float):
        """One bucket's solve from bank rows ``sl`` -> (rows, iterations,
        reasons); iterations and reasons are tensors or host lists."""
        cfg = self.config
        d_local = sl.shape[1]
        if kind.startswith("sparse"):
            vg, hvp, _ = _sparse_objective(self.loss, ix, v, lab, off, w, l2)
        else:
            X = v if kind.endswith("_id") else densify(ix, v, d_local)
            if kind.startswith("newton"):
                return newton_solve(
                    self.loss, X, lab, off, w, sl, l2,
                    max_iter=cfg.max_iter, tol=cfg.tolerance,
                )
            vg, hvp = _dense_objective(self.loss, X, lab, off, w, l2)
        if cfg.optimizer_type == OptimizerType.TRON:
            res = minimize_tron(
                vg, hvp, sl, max_iter=cfg.max_iter, tol=cfg.tolerance,
                max_cg=cfg.tron_max_cg,
            )
        elif self.regularization.has_l1:
            res = minimize_owlqn(
                vg, sl, l1, max_iter=cfg.max_iter, tol=cfg.tolerance,
                history=cfg.lbfgs_history,
            )
        else:
            res = minimize_lbfgs(
                vg, sl, max_iter=cfg.max_iter, tol=cfg.tolerance,
                history=cfg.lbfgs_history,
            )
        return res.coefficients, res.iterations, res.reason

    def _bucket_inputs(self, bucket, bank: Tensor, residual_offsets: Optional[Tensor], values=None):
        """A bucket's solve inputs in the bank's dtype; ``values`` (a
        tensor, or a callable giving one) replaces its stored values."""
        ix, v, lab, w, off, rows, codes = self._bucket_device_args(
            bucket, bank.device, with_values=values is None
        )
        if values is not None:
            # a callable is gathered only now, so at most one bucket's
            # override values are alive at a time
            v = values() if callable(values) else values
        if residual_offsets is not None:
            # the residual currency stays on the device: one gather per bucket
            off = torch.where(
                rows >= 0, residual_offsets[rows.clamp_min(0)], 0.0
            ).to(residual_offsets.dtype)
        dt = bank.dtype
        return ix, v.to(dt), lab.to(dt), off.to(dt), w.to(dt), codes

    def update_bank(
        self,
        bank: Tensor,  # [E, D]
        dataset: RandomEffectDataset,
        residual_offsets: Optional[Tensor] = None,  # [n] replaces offsets
        values_override: Optional[Sequence] = None,
        with_variances: bool = False,
        defer_tracker: bool = False,
    ):
        """Solve every entity against its active data; -> (new bank,
        tracker), plus the per-entity variance bank [E, D] with
        ``with_variances`` (the Hdiag pass at the solved rows, same
        offsets). The caller's bank is not modified. With
        ``defer_tracker`` the stats stay on the device until first read.

        ``values_override``: per-bucket feature values on the device
        (aligned with ``dataset.buckets``), or callables that give them,
        in place of each bucket's stored values, which are then never
        read: the MF ALS path gathers latent views every half-step while
        the bucket structure stays cached."""
        l1, l2 = self.regularization.split(self.reg_weight)
        if residual_offsets is not None:
            residual_offsets = torch.as_tensor(residual_offsets, device=bank.device)
        bank = bank.clone()
        var_bank = torch.zeros_like(bank) if with_variances else None
        stats: List[Tuple[int, object, object]] = []
        routed, router = self._route_residuals(dataset, residual_offsets)
        for bi, bucket in enumerate(dataset.buckets):
            values = None if values_override is None else values_override[bi]
            kind = self._bucket_kind(bucket, bank.shape[1])
            if self.mesh is not None:
                stats.append(self._update_bucket_on_mesh(
                    bi, bucket, kind, bank, var_bank, routed, router, values, l1, l2,
                ))
                continue
            ix, v, lab, off, w, codes = self._bucket_inputs(
                bucket, bank, residual_offsets, values,
            )
            sl = bank.index_select(0, codes)
            new_sl, iters, reasons = self._solve(kind, sl, ix, v, lab, off, w, l1, l2)
            bank.index_copy_(0, codes, new_sl)
            if with_variances:
                hd = self._hdiag(new_sl, ix, v, lab, off, w, l2)
                var_bank.index_copy_(0, codes, 1.0 / (hd + _VARIANCE_EPSILON))
            stats.append((bucket.num_entities, iters, reasons))
        if stats:
            deferred = Deferred(stats, _finalize)
            tracker = LazyRandomEffectTracker(deferred) if defer_tracker else deferred.result()
        else:
            tracker = RandomEffectTracker(0, 0.0, 0, {})
        if with_variances:
            return bank, tracker, var_bank
        return bank, tracker

    # -- over a mesh ----------------------------------------------------------

    def _router_for(self, dataset: RandomEffectDataset):  # photon: entropy(id(mesh)-keyed router memo; identity-checked, in-memory only)
        """The dataset's ResidualRouter for this mesh, built once and kept
        on the dataset (its tables are static per dataset and mesh)."""
        from photon_ml_tpu_torch.game.residual_routing import ResidualRouter

        cache = dataset.__dict__.setdefault("_residual_routers", {})
        key = (id(self.mesh), self.mesh.rank)
        hit = cache.get(key)
        if hit is None or hit.mesh is not self.mesh:
            hit = cache[key] = ResidualRouter(self.mesh, dataset)
        return hit

    def _route_residuals(self, dataset, residual_offsets):
        """On a mesh, the residual offsets routed to this rank's bucket
        slabs by one all-to-all -> (routed buffer, router); else
        (None, None)."""
        if self.mesh is None or residual_offsets is None or not dataset.buckets:
            return None, None
        router = self._router_for(dataset)
        return router.route(residual_offsets), router

    def _mesh_slice(self, bucket, device, with_values: bool):
        """This rank's slice of a bucket's entities, padded to ``E_loc``
        (zero data: a pad lane converges at iteration 0), uploaded once and
        kept on the bucket -> (ix, v, lab, w, off, codes, real rows, start)."""
        axis = self.mesh.axis_names[0]
        n_dev, me = self.mesh.size(axis), self.mesh.index(axis)
        cache = bucket.__dict__.setdefault("_mesh_args", {})
        key = (device, n_dev, me, with_values)
        hit = cache.get(key)
        if hit is None:
            E = bucket.num_entities
            e_loc = -(-E // n_dev)
            lo, hi = min(me * e_loc, E), min((me + 1) * e_loc, E)

            def cut(a, dtype=None):
                part = np.asarray(a[lo:hi])
                pad = np.zeros((e_loc - part.shape[0],) + part.shape[1:], part.dtype)
                t = torch.as_tensor(np.concatenate([part, pad]), device=device)
                return t if dtype is None else t.to(dtype)

            hit = (
                cut(bucket.indices, torch.int64),
                cut(bucket.values) if with_values else None,
                cut(bucket.labels), cut(bucket.weights), cut(bucket.offsets),
                torch.as_tensor(bucket.entity_codes[lo:hi], device=device).long(),
                hi - lo, lo,
            )
            cache[key] = hit
        return hit

    def _update_bucket_on_mesh(self, bi, bucket, kind, bank, var_bank, routed, router,
                               values, l1, l2):
        """Solve this rank's slice of one bucket; every rank's solved rows
        (and variances) come back by one all-gather in rank order and land
        in the whole bank on every rank. -> the bucket's tracker stats."""
        axis = self.mesh.axis_names[0]
        n_dev = self.mesh.size(axis)
        ix, v, lab, w, off, codes, n_mine, lo = self._mesh_slice(
            bucket, bank.device, values is None
        )
        e_loc = ix.shape[0]
        if values is not None:
            v = values() if callable(values) else values
            v = v[lo:lo + n_mine]
            v = torch.cat([v, v.new_zeros((e_loc - n_mine,) + tuple(v.shape[1:]))])
        if routed is not None:
            off = router.bucket_slab(routed, bi, bucket.capacity)
        dt = bank.dtype
        v, lab, off, w = v.to(dt), lab.to(dt), off.to(dt), w.to(dt)
        sl = bank.new_zeros(e_loc, bank.shape[1])
        sl[:n_mine] = bank.index_select(0, codes)
        new_sl, iters, reasons = self._solve(kind, sl, ix, v, lab, off, w, l1, l2)
        parts = [new_sl]
        if var_bank is not None:
            hd = self._hdiag(new_sl, ix, v, lab, off, w, l2)
            parts.append(1.0 / (hd + _VARIANCE_EPSILON))
        ints = torch.stack([
            torch.as_tensor(iters, device=bank.device).reshape(-1).to(torch.int64),
            torch.as_tensor(reasons, device=bank.device).reshape(-1).to(torch.int64),
        ])
        from photon_ml_tpu_torch.parallel.shuffle import gather

        E = bucket.num_entities
        all_codes = torch.as_tensor(bucket.entity_codes, device=bank.device).long()
        rows = gather(torch.cat(parts, dim=-1), self.mesh, axis).reshape(n_dev * e_loc, -1)[:E]
        d = bank.shape[1]
        bank.index_copy_(0, all_codes, rows[:, :d])
        if var_bank is not None:
            var_bank.index_copy_(0, all_codes, rows[:, d:])
        ints = gather(ints, self.mesh, axis)  # [n_dev, 2, e_loc]
        it_all = ints[:, 0].reshape(-1)[:E]
        rs_all = ints[:, 1].reshape(-1)[:E]
        return (E, it_all, rs_all)

    def _hdiag(self, sl, ix, v, lab, off, w, l2) -> Tensor:
        """Per-entity Hessian diagonals at bank rows ``sl``:
        sum_s w_s l''(z_s) x_{s,j}^2 + l2 (the computeVariances input)."""
        _, _, hdiag = _sparse_objective(self.loss, ix, v, lab, off, w, l2)
        return hdiag(sl)

    def bank_variances(
        self,
        bank: Tensor,
        dataset: RandomEffectDataset,
        residual_offsets: Optional[Tensor] = None,
    ) -> Tensor:
        """Per-entity coefficient variances 1/(Hdiag + eps) at the bank,
        [E, D] aligned with it: one Hdiag pass per bucket, no solve."""
        _, l2 = self.regularization.split(self.reg_weight)
        if residual_offsets is not None:
            residual_offsets = torch.as_tensor(residual_offsets, device=bank.device)
        variances = torch.zeros_like(bank)
        if self.mesh is not None:
            # the Hdiag pass of the mesh update, without its solve
            return self._variances_on_mesh(bank, dataset, residual_offsets, variances, l2)
        for bucket in dataset.buckets:
            ix, v, lab, off, w, codes = self._bucket_inputs(bucket, bank, residual_offsets)
            hd = self._hdiag(bank.index_select(0, codes), ix, v, lab, off, w, l2)
            variances.index_copy_(0, codes, 1.0 / (hd + _VARIANCE_EPSILON))
        return variances

    def _variances_on_mesh(self, bank, dataset, residual_offsets, variances, l2):
        from photon_ml_tpu_torch.parallel.shuffle import gather

        axis = self.mesh.axis_names[0]
        n_dev = self.mesh.size(axis)
        routed, router = self._route_residuals(dataset, residual_offsets)
        for bi, bucket in enumerate(dataset.buckets):
            ix, v, lab, w, off, codes, n_mine, _ = self._mesh_slice(bucket, bank.device, True)
            if routed is not None:
                off = router.bucket_slab(routed, bi, bucket.capacity)
            dt = bank.dtype
            sl = bank.new_zeros(ix.shape[0], bank.shape[1])
            sl[:n_mine] = bank.index_select(0, codes)
            hd = self._hdiag(sl, ix, v.to(dt), lab.to(dt), off.to(dt), w.to(dt), l2)
            E = bucket.num_entities
            rows = gather(1.0 / (hd + _VARIANCE_EPSILON), self.mesh, axis)
            variances.index_copy_(
                0, torch.as_tensor(bucket.entity_codes, device=bank.device).long(),
                rows.reshape(n_dev * ix.shape[0], -1)[:E],
            )
        return variances

    def regularization_term(self, bank: Tensor) -> float:
        """Sum of per-entity reg terms (Coordinate.regTerm analog)."""
        return float(self.regularization_term_device(bank))

    def regularization_term_device(self, bank: Tensor) -> Tensor:
        """The reg term as a device scalar (no readback)."""
        l1, l2 = self.regularization.split(self.reg_weight)
        term = 0.5 * l2 * (bank * bank).sum()
        if l1:
            term = term + l1 * bank.abs().sum()
        return term


def _finalize(stats) -> RandomEffectTracker:
    """Per-bucket (entities, iterations, reasons), fetched to the host ->
    the tracker."""
    total, it_sum, it_max = 0, 0, 0
    counts = np.zeros(_N_REASONS, np.int64)
    for n, it, rs in stats:
        it, rs = np.asarray(it), np.asarray(rs)
        total += n
        it_sum += int(it.sum())
        it_max = max(it_max, int(it.max()) if it.size else 0)
        counts += np.bincount(rs.astype(np.int64), minlength=_N_REASONS)[:_N_REASONS]
    return RandomEffectTracker(
        num_entities=total,
        iterations_mean=it_sum / total,
        iterations_max=it_max,
        reason_counts={
            CONVERGENCE_REASON_NAMES.get(code, "?"): int(cnt)
            for code, cnt in enumerate(counts) if cnt
        },
    )


def device_row_view(dataset: RandomEffectDataset):
    """Device copies of the row-aligned arrays (codes clamped, valid mask,
    local indices as int64, local values), uploaded once per dataset."""
    hit = dataset.__dict__.get("_device_rows")
    if hit is None:
        dev = dataset.device
        codes = torch.as_tensor(dataset.row_entity_codes, device=dev).to(torch.int64)
        hit = (
            codes.clamp_min(0),
            codes >= 0,
            torch.as_tensor(dataset.row_local_indices, device=dev).to(torch.int64),
            torch.as_tensor(dataset.row_local_values, device=dev),
        )
        dataset.__dict__["_device_rows"] = hit
    return hit


def score_random_effect(bank: Tensor, dataset: RandomEffectDataset) -> Tensor:
    """Row-aligned scores [n]: score_i = x_i(local) . bank[entity_i].

    Covers active and passive rows (features unseen in the entity's active
    data have zero coefficients, RandomEffectCoordinate.scala:178-199).
    The bank is gathered as ``bank[codes[:, None], ix]`` ([n, k]), the
    same result as the reference's ``[n, D]`` row gather without
    materializing it, and each row sums in the fixed order (module
    note), as the pod's owners score their slots."""
    codes, valid, ix, v = device_row_view(dataset)
    score = _dot(v.to(bank.dtype), bank[codes[:, None], ix])
    return torch.where(valid, score, 0.0)
