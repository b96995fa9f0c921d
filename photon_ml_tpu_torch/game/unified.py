"""Unified (grid × entity) GAME training (port of
``photon_ml_tpu/game/unified.py``).

The pod path (``game/pod.py``) trains ONE entity-sharded GAME model; a
λ-grid over it would run G pod CD loops one after another. Here every pod
currency gains a leading member axis, so the whole sweep runs at once on
the ``parallel/unified_mesh.py`` (grid, entity) mesh of ranks:

- :class:`GridShardedREBank`: the pod ``[E_loc, d]`` shard becomes this
  rank's ``[G_loc, E_loc, d]`` block: the members of its grid row, the
  rows of its entity shard (the pod's hash placement, member by member).
- The grid update, score and route-in: the pod programs with the member
  axis folded into the solvers' batch (lanes ``[G_loc * e_blk]``, each
  with its member's ``l2``), so one solve serves every member of the row
  and a converged member's lanes freeze while the others run on. Each
  residual exchange is ONE all-to-all for the row: the reference's
  ``[G_loc, n_dev, cap]`` blocks with ``split_axis=1`` become one
  ``all_to_all_single`` after moving the ``n_dev`` axis first.
- :class:`UnifiedGridREProblem`: the pod problem's twin over the grid
  bank; it reuses ``pod._PodView`` unchanged (its router tables, slots
  and blocks are λ-independent).
- :func:`run_game_grid`: coordinate descent over (fixed effect +
  entity-sharded random effect) for every member at once, with the CD
  residual algebra of ``game/coordinate_descent.py`` and one batched
  readback per CD iteration.

Scope (the reference's): the fixed effect runs the batched scatter solve
with its bank whole on every rank of its grid row, and the unified RE
update computes no variance banks. A member's regularization with an L1
part is solved member by member (the folded batch takes one ``l2`` a
lane, not an ``l1``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.game.pod import (
    _N_REASONS,
    EntityShardSpec,
    PodRandomEffectModel,
    ShardedREBank,
    _PodView,
    _slot_offsets,
    per_device_bytes,
)
from photon_ml_tpu_torch.game.random_effect import RandomEffectTracker
from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, GRID_AXIS
from photon_ml_tpu_torch.parallel.multihost import sum_in_rank_order
from photon_ml_tpu_torch.parallel.shuffle import exchange, gather, row_block
from photon_ml_tpu_torch.parallel.unified_mesh import MeshPlan

Tensor = torch.Tensor

__all__ = [
    "GridShardedREBank",
    "UnifiedGridREProblem",
    "UnifiedGridGameResult",
    "run_game_grid",
]


class GridShardedREBank:
    """A λ-grid of entity-sharded random-effect banks: ``data`` is this
    rank's ``[G_loc, E_loc, d]`` block (the members ``row * G_loc ..`` of
    its grid row, the local rows of its entity shard). The whole layout,
    ``[G_pad, n_shards * E_loc, d]`` with member g's entity ``e`` at row
    ``(e % n) * E_loc + e // n``, is the reference's; padding members
    (index >= ``grid_size``) run inert duplicates of the last λ."""

    __slots__ = ("mesh", "spec", "grid_size", "grid_padded", "data")

    def __init__(self, mesh, spec: EntityShardSpec, grid_size: int, grid_padded: int,
                 data: Tensor):
        self.mesh = mesh
        self.spec = spec
        self.grid_size = int(grid_size)
        self.grid_padded = int(grid_padded)
        self.data = data

    @property
    def dim(self) -> int:
        return int(self.data.shape[2])

    @property
    def members_per_row(self) -> int:
        return int(self.data.shape[0])

    @classmethod
    def zeros(cls, mesh, spec: EntityShardSpec, grid_size: int, grid_padded: int, dim: int,
              dtype=torch.float32) -> "GridShardedREBank":
        g_loc = grid_padded // mesh.size(GRID_AXIS)
        data = torch.zeros(g_loc, spec.rows_per_shard, dim, dtype=dtype, device=mesh.device)
        return cls(mesh, spec, grid_size, grid_padded, data)

    @classmethod
    def from_member_globals(cls, mesh, spec: EntityShardSpec, grid_size: int,
                            banks) -> "GridShardedREBank":
        """``[E, d]`` entity-code-ordered member banks (whole on every rank)
        -> this rank's block; a list short of a multiple of the grid rows
        is padded by repeating the last member."""
        banks = [torch.as_tensor(b, device=mesh.device) for b in banks]
        if not banks:
            raise ValueError("empty member bank list")
        rows = mesh.size(GRID_AXIS)
        while len(banks) % rows:
            banks.append(banks[-1])
        g_loc = len(banks) // rows
        row = mesh.index(GRID_AXIS)
        mine = torch.stack(banks[row * g_loc:(row + 1) * g_loc])
        e = spec.shard_entities(mesh.index(ENTITY_AXIS))
        valid = e < spec.num_entities
        data = mine.new_zeros(g_loc, spec.rows_per_shard, mine.shape[2])
        if valid.any():
            data[:, : int(valid.sum())] = mine[:, torch.as_tensor(e[valid], device=mine.device)]
        return cls(mesh, spec, grid_size, len(banks), data)

    def _all_members(self) -> Tensor:
        """``[G_pad, E_loc, d]`` of this rank's entity shard: every grid
        row's block, gathered over the grid axis."""
        parts = gather(self.data, self.mesh, GRID_AXIS)  # [rows, G_loc, E_loc, d]
        return parts.reshape(-1, *self.data.shape[1:])

    def member(self, g: int) -> ShardedREBank:
        """Member g's bank as a pod ShardedREBank on every rank (a gather
        over the grid axis: every rank calls it together)."""
        rows = self.mesh.size(GRID_AXIS)
        if rows == 1:
            data = self.data[g]
        else:
            data = self._all_members()[g]
        return ShardedREBank(self.mesh, self.spec, data.contiguous(), ENTITY_AXIS)

    def member_global(self, g: int) -> Tensor:
        """Member g's whole ``[E, d]`` bank (export, checkpoints, parity
        checks; the CD hot path never calls it)."""
        return self.member(g).to_global()

    def snapshot(self) -> np.ndarray:
        """Host copy of the RAW ``[G_pad, n * E_loc, d]`` layout for the
        checkpoint plane (``GridCheckpointer.save_grid_bank``): the rows
        stay in hash placement, byte for byte the reference's array.
        Every rank calls it together."""
        shards = gather(self._all_members(), self.mesh, ENTITY_AXIS)  # [n, G_pad, E_loc, d]
        whole = shards.permute(1, 0, 2, 3).reshape(self.grid_padded, -1, self.dim)
        return whole.detach().cpu().numpy()

    def layout(self) -> Dict[str, int]:
        """Marker metadata guarding a snapshot against a restore onto
        another mesh / shard layout."""
        return {
            "grid_size": self.grid_size,
            "grid_padded": self.grid_padded,
            "num_shards": self.spec.num_shards,
            "num_entities": self.spec.num_entities,
            "dim": self.dim,
        }

    @classmethod
    def restore(cls, mesh, spec: EntityShardSpec, grid_size: int, data) -> "GridShardedREBank":
        """A :meth:`snapshot` array back onto the mesh: this rank keeps its
        members' rows of its entity shard."""
        arr = torch.as_tensor(np.asarray(data), device=mesh.device)
        if arr.dim() != 3 or int(arr.shape[1]) != spec.bank_rows:
            raise ValueError(
                f"snapshot shape {tuple(arr.shape)} does not match the "
                f"{spec.num_shards}-shard bank layout ({spec.bank_rows} rows)"
            )
        g_pad = int(arr.shape[0])
        if g_pad % mesh.size(GRID_AXIS):
            raise ValueError(
                f"snapshot of {g_pad} members does not split over "
                f"{mesh.size(GRID_AXIS)} grid rows"
            )
        g_loc = g_pad // mesh.size(GRID_AXIS)
        row, shard = mesh.index(GRID_AXIS), mesh.index(ENTITY_AXIS)
        e_loc = spec.rows_per_shard
        block = arr[row * g_loc:(row + 1) * g_loc, shard * e_loc:(shard + 1) * e_loc]
        return cls(mesh, spec, grid_size, g_pad, block.contiguous())

    def per_device_bytes(self) -> int:
        return per_device_bytes(self.data)


# ---------------------------------------------------------------------------
# the grid programs, as each rank's code
# ---------------------------------------------------------------------------


def _grid_exchange(blocks: Tensor, mesh) -> Tensor:
    """``[G_loc, n_dev, cap]`` -> the same after the all-to-all over the
    entity axis on the ``n_dev`` axis (the reference's ``split_axis=1``):
    one ``all_to_all_single`` with ``n_dev`` moved first."""
    moved = blocks.permute(1, 0, 2).contiguous()
    return exchange(moved, mesh, ENTITY_AXIS).permute(1, 0, 2)


def _member_stats(iters, reasons, valid: Tensor, g_loc: int) -> Tensor:
    """[G_loc, 2 + R] per member: sum and max of its valid lanes'
    iterations, and its reason counts."""
    e_blk = valid.shape[0]
    it = torch.as_tensor(iters, device=valid.device).reshape(g_loc, e_blk).to(torch.int64)
    rs = torch.as_tensor(reasons, device=valid.device).reshape(g_loc, e_blk).to(torch.int64)
    vi = torch.where(valid, it, 0)
    r = torch.where(valid, rs, _N_REASONS)
    onehot = r[..., None] == torch.arange(_N_REASONS + 1, device=valid.device)
    counts = onehot.to(torch.int64).sum(dim=1)[:, :_N_REASONS]
    return torch.cat([vi.sum(dim=1, keepdim=True), vi.max(dim=1, keepdim=True).values, counts],
                     dim=1)


# ---------------------------------------------------------------------------
# the grid problem
# ---------------------------------------------------------------------------


class UnifiedGridREProblem:
    """λ-grid × entity-sharded twin of PodRandomEffectProblem: one grid
    bank, each member's ``(l1, l2)`` from ``regularization.split(
    reg_weights[g])``, ``pod._PodView`` reused as it is, every update,
    score and exchange grid-batched. ``base`` must carry ``mesh=None``:
    placement is the unified mesh plan's."""

    def __init__(self, base, plan: MeshPlan, reg_weights: Sequence[float]):
        if base.mesh is not None:
            raise ValueError(
                "UnifiedGridREProblem wraps a mesh-less base problem; "
                "placement is owned by the unified mesh plan"
            )
        mesh = plan.mesh
        names = tuple(getattr(mesh, "axis_names", ()))
        if GRID_AXIS not in names or ENTITY_AXIS not in names:
            raise ValueError(
                f"unified mesh must carry ({GRID_AXIS!r}, {ENTITY_AXIS!r}) "
                f"axes, got {names!r}"
            )
        weights = [float(w) for w in reg_weights]
        if len(weights) != plan.grid_size:
            raise ValueError(
                f"{len(weights)} reg weights for a grid of {plan.grid_size} members"
            )
        self.base = base
        self.plan = plan
        self.mesh = mesh
        self.num_shards = mesh.size(ENTITY_AXIS)
        self.reg_weights = weights
        padded = plan.pad_members(weights)
        mine = [padded[g] for g in plan.members_of_row(mesh.index(GRID_AXIS))]
        splits = [base.regularization.split(w) for w in mine]
        self._l1 = [float(s[0]) for s in splits]
        self._l2 = [float(s[1]) for s in splits]
        self._views: Dict[int, tuple] = {}

    @property
    def members_per_row(self) -> int:
        return self.plan.members_per_row

    def spec_for(self, dataset) -> EntityShardSpec:
        return EntityShardSpec(self.num_shards, dataset.num_entities)

    def init_bank(self, dataset, dtype=torch.float32) -> GridShardedREBank:
        return GridShardedREBank.zeros(
            self.mesh, self.spec_for(dataset), self.plan.grid_size, self.plan.grid_padded,
            dataset.local_dim, dtype=dtype,
        )

    def pod_view(self, dataset) -> _PodView:  # photon: entropy(id-keyed view memo; weakref-pinned, in-memory only)
        key = id(dataset)
        hit = self._views.get(key)
        if hit is not None and hit[0]() is dataset:
            return hit[1]
        view = _PodView(self.mesh, dataset, self.base, axis=ENTITY_AXIS)
        cache = self._views
        ref = weakref.ref(dataset, lambda _, k=key, c=cache: c.pop(k, None))
        cache[key] = (ref, view)
        return view

    def prepare(self, dataset) -> None:
        self.pod_view(dataset)

    def _local_rows(self, residual_bank) -> Tensor:
        """This row's members' ``[G_loc, n]`` rows of a ``[G_pad, n]`` or
        ``[G_loc, n]`` per-member row bank."""
        g_loc = self.members_per_row
        if residual_bank.shape[0] == g_loc:
            return residual_bank
        if residual_bank.shape[0] != self.plan.grid_padded:
            raise ValueError(
                f"residual bank carries {residual_bank.shape[0]} members, "
                f"expected the padded grid {self.plan.grid_padded} (or this "
                f"row's {g_loc})"
            )
        row = self.mesh.index(GRID_AXIS)
        return residual_bank[row * g_loc:(row + 1) * g_loc]

    def route_in(self, view: _PodView, residual_bank: Tensor) -> Tensor:
        """Per-member residual/offset rows -> this rank's ``[G_loc,
        num_slots]`` routed slots, ONE all-to-all for the row's members."""
        router = view.router
        vals = self._local_rows(residual_bank)
        g_loc = vals.shape[0]
        block = torch.stack([
            row_block(vals[m], router.n_dev, router.index, router.num_rows_padded)
            for m in range(g_loc)
        ])
        buf = block.new_zeros(g_loc, router.num_slots + 1)
        buf[:, router._send_pos] = block
        blocks = buf[:, :-1].reshape(g_loc, router.n_dev, router.cap)
        return _grid_exchange(blocks, self.mesh).reshape(g_loc, -1)

    def update_bank(self, bank: GridShardedREBank, dataset, residual_bank: Tensor,
                    defer_tracker: bool = False):
        """One grid-batched cross-replica bank update. ``residual_bank`` is
        the per-member offsets-plus-residual rows (``[G_pad, n]`` whole, or
        this row's ``[G_loc, n]``). -> ``(new bank, trackers)``: a list of
        the G members' RandomEffectTrackers, or with ``defer_tracker`` a
        Deferred giving it (for the CD loop's one batched readback)."""
        view = self.pod_view(dataset)
        dt = bank.data.dtype
        slots = self.route_in(view, torch.as_tensor(residual_bank).to(dt))  # hop 1
        data = bank.data.clone()  # [G_loc, E_loc, d]
        g_loc, e_loc, d = data.shape
        l2_all = set(self._l2)
        has_l1 = any(self._l1)
        n_reals: List[int] = []
        stat_vecs: List[Tensor] = []
        for blk in view.blocks:
            e_blk = blk.valid.shape[0]
            m = blk.num_mine
            safe = blk.lrow.clamp_max(e_loc - 1)
            sl = torch.where(blk.valid[None, :, None], data[:, safe], 0.0)  # [G_loc, e_blk, d]
            off = torch.stack([_slot_offsets(blk.offslot, slots[g]) for g in range(g_loc)])
            v, lab, w = blk.v.to(dt), blk.lab.to(dt), blk.w.to(dt)
            if has_l1:
                # OWL-QN takes one l1: member by member
                outs = [
                    self.base._solve(blk.kind, sl[g], blk.ix, v, lab, off[g], w,
                                     self._l1[g], self._l2[g])
                    for g in range(g_loc)
                ]
                new_sl = torch.stack([o[0] for o in outs])
                iters = torch.stack([torch.as_tensor(o[1]).reshape(-1) for o in outs])
                reasons = torch.stack([torch.as_tensor(o[2]).reshape(-1) for o in outs])
            else:
                # the member axis folds into the solvers' batch
                def fold(t):
                    return t.expand((g_loc,) + tuple(t.shape)).reshape((-1,) + tuple(t.shape[1:]))

                l2 = (self._l2[0] if len(l2_all) == 1 else torch.tensor(
                    self._l2, dtype=dt, device=data.device).repeat_interleave(e_blk))
                new_sl, iters, reasons = self.base._solve(
                    blk.kind, sl.reshape(-1, d), fold(blk.ix), fold(v), fold(lab),
                    off.reshape(g_loc * e_blk, -1), fold(w), 0.0, l2,
                )
                new_sl = new_sl.reshape(g_loc, e_blk, d)
            if m:
                data[:, blk.lrow[:m]] = new_sl[:, :m]
            n_reals.append(blk.num_real)
            stat_vecs.append(_member_stats(iters, reasons, blk.valid, g_loc))
        new_bank = GridShardedREBank(self.mesh, bank.spec, bank.grid_size, bank.grid_padded, data)
        if not stat_vecs:
            return new_bank, [RandomEffectTracker(0, 0.0, 0, {}) for _ in range(bank.grid_size)]
        local = torch.stack(stat_vecs)  # [B, G_loc, 2 + R]
        parts = gather(local, self.mesh, ENTITY_AXIS)  # entity-axis psum / pmax
        stats = parts.sum(dim=0)
        stats[..., 1] = parts[..., 1].max(dim=0).values
        rows = gather(stats, self.mesh, GRID_AXIS)  # [rows, B, G_loc, 2 + R]
        stats = rows.permute(1, 0, 2, 3).reshape(stats.shape[0], -1, stats.shape[2])
        total = max(sum(n_reals), 1)
        g = bank.grid_size

        def _finalize(all_stats, total=total, g=g):
            all_stats = np.asarray(all_stats)  # [B, G_pad, 2 + R]
            out = []
            for member in range(g):
                s = all_stats[:, member, :]
                count_vec = s[:, 2:].sum(axis=0)
                out.append(RandomEffectTracker(
                    num_entities=total,
                    iterations_mean=float(s[:, 0].sum()) / total,
                    iterations_max=int(s[:, 1].max()),
                    reason_counts={
                        CONVERGENCE_REASON_NAMES.get(code, "?"): int(cnt)
                        for code, cnt in enumerate(count_vec) if cnt
                    },
                ))
            return out

        deferred = overlap.Deferred(stats, _finalize)
        if defer_tracker and not deferred.done:
            return new_bank, deferred
        return new_bank, deferred.result()

    def score(self, bank: GridShardedREBank, dataset) -> Tensor:
        """``[G_loc, n]`` row-aligned scores of this row's members, whole
        rows on every rank of the row: owners score their slots, ONE
        reverse all-to-all for the row's members, the row blocks gathered
        over the entity axis in rank order."""
        view = self.pod_view(dataset)
        router = view.router
        data = bank.data
        g_loc, e_loc, _ = data.shape
        w_rows = data[:, view.slot_lrow.clamp_max(e_loc - 1)]  # [G_loc, slots, d]
        ix = view.slot_ix.expand((g_loc,) + tuple(view.slot_ix.shape))
        s = (view.slot_v.to(data.dtype) * torch.gather(w_rows, 2, ix)).sum(dim=-1)
        s = torch.where(view.slot_valid, s, 0.0)
        back = _grid_exchange(s.reshape(g_loc, router.n_dev, router.cap), self.mesh)
        back = back.reshape(g_loc, -1)
        pos = router._send_pos
        local = torch.where(pos < router.num_slots, back[:, pos.clamp_max(router.num_slots - 1)],
                            0.0)
        rows = gather(local, self.mesh, ENTITY_AXIS)  # [n, G_loc, per]
        return rows.permute(1, 0, 2).reshape(g_loc, -1)[:, : router.num_rows]

    def regularization_term_device(self, bank: GridShardedREBank) -> Tensor:
        """``[G_loc]`` reg terms of this row's members over the sharded
        bank (each rank's partials summed in rank order)."""
        data = bank.data
        l2 = torch.tensor(self._l2, dtype=data.dtype, device=data.device)
        l1 = torch.tensor(self._l1, dtype=data.dtype, device=data.device)
        term = 0.5 * l2 * (data * data).sum(dim=(1, 2)) + l1 * data.abs().sum(dim=(1, 2))
        if self.mesh.size(ENTITY_AXIS) == 1:
            return term
        return sum_in_rank_order(term, self.mesh.groups[ENTITY_AXIS])


# ---------------------------------------------------------------------------
# the unified coordinate-descent trainer
# ---------------------------------------------------------------------------


@dataclass
class UnifiedGridGameResult:
    """Per-member outcome of one unified grid CD run. ``fe_banks``: the
    final ``[G_pad, d]`` fixed-effect bank (whole on every rank);
    ``re_bank``: the final grid-sharded RE bank; histories and trackers
    align with ``re_reg_weights`` (padding members dropped)."""

    plan: MeshPlan
    re_reg_weights: List[float]
    fe_banks: Tensor
    re_bank: GridShardedREBank
    objective_history: List[List[float]] = field(default_factory=list)
    fe_trackers: List[object] = field(default_factory=list)
    re_trackers: List[List[RandomEffectTracker]] = field(default_factory=list)
    readbacks: int = 0  # device->host readbacks of the CD loop

    def fe_means(self, g: int) -> Tensor:
        return self.fe_banks[g]

    def re_member(self, g: int) -> ShardedREBank:
        return self.re_bank.member(g)

    def re_model(self, g: int, re_dataset) -> PodRandomEffectModel:
        return PodRandomEffectModel(
            self.re_bank.member(g), re_dataset,
            re_dataset.config.random_effect_type, re_dataset.config.feature_shard_id,
        )


def _fe_scores(bank: Tensor, batch) -> Tensor:
    """``[G, n]`` scores of every member's fixed-effect coefficients (no
    offsets)."""
    vals = batch.values.to(bank.dtype)
    return (vals[None] * bank[:, batch.indices.long()]).sum(dim=-1)


def run_game_grid(
    plan: MeshPlan,
    dataset,
    re_dataset,
    fe_problem,
    re_problem,
    re_reg_weights: Sequence[float],
    *,
    feature_shard_id: str,
    fe_reg_weight: float = 0.0,
    num_iterations: int = 2,
    down_sampling_rate: float = 1.0,
    sampler_seed: int = 0,
) -> UnifiedGridGameResult:
    """λ-grid GAME coordinate descent over (fixed effect, entity-sharded
    random effect) for EVERY member of ``re_reg_weights`` at once: the FE
    solves batch through ``GLMOptimizationProblem.run_grid`` with each
    member's own offsets (``offsets_bank``), the RE updates and scores run the grid programs,
    and each CD iteration makes ONE batched readback (the ``[G]``
    objectives plus the RE tracker stats). Per member it is the pod CD
    loop: the same warm starts (each member from its own previous
    coefficients), one λ-independent down-sampling draw, the same
    objective (loss + FE reg + RE reg). Every rank of ``plan.mesh`` calls
    it with the same arguments and gets the same result."""
    from photon_ml_tpu_torch.data.sampler import down_sample

    mesh = plan.mesh
    G = plan.grid_size
    uni = UnifiedGridREProblem(re_problem, plan, re_reg_weights)
    uni.pod_view(re_dataset)
    re_bank = uni.init_bank(re_dataset)
    g_loc = plan.members_per_row

    batch = dataset.batch_for_shard(feature_shard_id)
    dev = batch.labels.device
    if down_sampling_rate < 1.0:
        # one λ-independent draw, the sequential coordinate's stream
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(sampler_seed))
        batch = down_sample(gen, batch, down_sampling_rate, fe_problem.task)
    base_off = batch.offsets.to(torch.float32)
    fe_weights = [float(fe_reg_weight)] * g_loc
    fe_l1, fe_l2 = fe_problem.regularization.split(float(fe_reg_weight))
    loss = fe_problem.objective.loss
    n = base_off.shape[0]

    fe_bank = torch.zeros(g_loc, fe_problem.objective.dim, device=dev)
    fe_scores = torch.zeros(g_loc, n, device=dev)
    re_scores = torch.zeros(g_loc, n, device=dev)
    result = UnifiedGridGameResult(
        plan=plan, re_reg_weights=[float(w) for w in re_reg_weights],
        fe_banks=fe_bank, re_bank=re_bank,
    )
    before = overlap.readback_stats()
    for _ in range(int(num_iterations)):
        total = fe_scores + re_scores
        # -- fixed effect: residual = total - own; one batched solve
        residual = total - fe_scores
        _, fe_result = fe_problem.run_grid(
            batch, fe_weights, initial=fe_bank, offsets_bank=base_off[None, :] + residual,
        )
        fe_bank = fe_result.coefficients
        fe_scores = _fe_scores(fe_bank, batch)
        total = residual + fe_scores
        # -- random effect: grid update + fused score exchange
        residual = total - re_scores
        re_bank, tracker_d = uni.update_bank(
            re_bank, re_dataset, base_off[None, :] + residual, defer_tracker=True,
        )
        re_scores = uni.score(re_bank, re_dataset)
        total = residual + re_scores
        # -- one batched readback: [G] objectives + the RE tracker stats
        z = total + base_off[None, :]
        value = (batch.weights[None, :] * loss.value(z, batch.labels[None, :])).sum(dim=1)
        fe_reg = 0.5 * fe_l2 * (fe_bank * fe_bank).sum(dim=1)
        if fe_l1:
            fe_reg = fe_reg + fe_l1 * fe_bank.abs().sum(dim=1)
        obj = value + fe_reg + uni.regularization_term_device(re_bank)
        obj_all = gather(obj, mesh, GRID_AXIS).reshape(-1)
        obj_d = overlap.Deferred(obj_all, lambda a, g=G: [float(x) for x in np.asarray(a)[:g]])
        fetch = [obj_d]
        if hasattr(tracker_d, "result"):
            fetch.append(tracker_d)
        overlap.fetch_all(fetch)
        result.objective_history.append(obj_d.result())
        result.fe_trackers.append(fe_result)
        result.re_trackers.append(
            tracker_d.result() if hasattr(tracker_d, "result") else tracker_d
        )
    result.readbacks = overlap.readback_stats() - before
    result.fe_banks = gather(fe_bank, mesh, GRID_AXIS).reshape(-1, fe_bank.shape[1])
    result.re_bank = re_bank
    return result
