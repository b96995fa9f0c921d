"""Pod-scale GAME: entity-sharded random-effect banks with all-to-all
residual routing and cross-replica sharded updates (port of
``photon_ml_tpu/game/pod.py``).

The replicated path (``game/random_effect.py``) holds every random
effect's ``[E, d]`` bank on every rank, so a bank is capped by one card
however many ranks run. Here:

- **Hash placement** (:class:`EntityShardSpec`): entity ``e`` lives on
  shard ``e % n`` at local row ``e // n`` (``ownership.py``, the one rule
  the serving loader and router share).
- **Sharded banks** (:class:`ShardedREBank`): each rank of the ``entity``
  axis holds only its ``[E_loc, d]`` shard; variances shard the same way.
- **Sharded updates** (:class:`PodRandomEffectProblem`): each rank solves
  only its own entities with the replicated path's bucket solvers, in
  per-shard blocks padded to the widest shard of the bucket; the tracker
  stats are gathered across ranks and reduced.
- **Two-hop residual routing** (``residual_routing.PodResidualRouter``):
  one all-to-all carries each row's residual to its entity's owner, the
  owner solves and scores locally, the reverse all-to-all carries the
  scores back.

A ``shard_map`` body of the reference is each rank's own code here; its
``lax.all_to_all`` is ``dist.all_to_all_single`` on the axis's group, its
``psum`` of floats ``multihost.sum_in_rank_order`` (bitwise repeatable),
its integer ``psum`` / ``pmax`` an all-gather then the reduction
(``parallel/shuffle.py``).
The reference donates the bank shard to its update program; the port
updates a copy of the shard in place.

The streamed path (``game/streaming.py``) reuses :meth:`~PodRandomEffectProblem.
update_segment`: each rank stages and solves only its own shard of every
segment.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.game.random_effect import (
    LazyRandomEffectTracker,
    RandomEffectOptimizationProblem,
    RandomEffectTracker,
)
from photon_ml_tpu_torch.game.random_effect_data import RandomEffectDataset
from photon_ml_tpu_torch.game.residual_routing import PodResidualRouter, rank_within
from photon_ml_tpu_torch.ops.kernels import entity_products
from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
from photon_ml_tpu_torch.optim.problem import _VARIANCE_EPSILON
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS
from photon_ml_tpu_torch.parallel.multihost import sum_in_rank_order
from photon_ml_tpu_torch.parallel.shuffle import gather

Tensor = torch.Tensor

__all__ = [
    "EntityShardSpec",
    "ShardedREBank",
    "PodRandomEffectProblem",
    "PodRandomEffectModel",
    "entity_shard_of",
    "per_device_bytes",
]

_N_REASONS = max(CONVERGENCE_REASON_NAMES) + 1


def entity_shard_of(codes, num_shards: int):
    """The one placement rule (entity code -> owning shard), shared by
    training, streaming, the serving shard loader and the router."""
    return ownership.owner_of(np.asarray(codes), int(num_shards))


@dataclass(frozen=True)
class EntityShardSpec:
    """Static placement of an entity axis over ``num_shards`` ranks."""

    num_shards: int
    num_entities: int

    @property
    def rows_per_shard(self) -> int:
        """Local bank rows per shard (>= 1 so empty banks stay valid)."""
        return ownership.rows_per_shard(self.num_entities, self.num_shards)

    @property
    def bank_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    def local_of(self, codes):
        return ownership.local_row_of(np.asarray(codes), self.num_shards)

    def sharded_row_of(self, codes):
        """Entity code -> row in the concatenated ``[n * E_loc, d]`` layout."""
        return ownership.sharded_row_of(np.asarray(codes), self.num_shards, self.rows_per_shard)

    def shard_entities(self, shard: int) -> np.ndarray:
        """The codes held at local rows ``0..E_loc-1`` of ``shard`` (codes at
        or past ``num_entities`` are padding rows)."""
        return np.arange(self.rows_per_shard, dtype=np.int64) * self.num_shards + shard


class ShardedREBank:
    """One random-effect coefficient (or variance) bank, hash-sharded over
    the mesh's entity axis: ``data`` is this rank's ``[E_loc, d]`` shard,
    entity ``e`` at local row ``e // n`` of rank ``e % n``. Padding rows
    (codes past the entity count) are zeros and inert everywhere."""

    __slots__ = ("mesh", "spec", "data", "axis")

    def __init__(self, mesh, spec: EntityShardSpec, data: Tensor, axis: Optional[str] = None):
        self.mesh = mesh
        self.spec = spec
        self.data = data
        self.axis = axis or ENTITY_AXIS

    @property
    def dim(self) -> int:
        return int(self.data.shape[1])

    @classmethod
    def zeros(cls, mesh, spec: EntityShardSpec, dim: int, *, dtype=torch.float32,
              axis: Optional[str] = None) -> "ShardedREBank":
        data = torch.zeros(spec.rows_per_shard, dim, dtype=dtype, device=mesh.device)
        return cls(mesh, spec, data, axis)

    @classmethod
    def from_global(cls, mesh, spec: EntityShardSpec, bank, *,
                    axis: Optional[str] = None) -> "ShardedREBank":
        """``[E, d]`` entity-code-ordered bank (whole on every rank) -> this
        rank's shard; no communication."""
        axis = axis or ENTITY_AXIS
        bank = torch.as_tensor(bank, device=mesh.device)
        if not bank.is_floating_point():
            bank = bank.to(torch.float32)
        e = spec.shard_entities(mesh.index(axis))
        valid = e < spec.num_entities
        rows = bank.new_zeros(spec.rows_per_shard, bank.shape[1])
        if valid.any():
            idx = torch.as_tensor(e[valid], device=bank.device)
            rows[: int(valid.sum())] = bank.index_select(0, idx)
        return cls(mesh, spec, rows, axis)

    def to_global(self) -> Tensor:
        """The whole ``[E, d]`` bank in entity-code order on every rank (an
        all-gather of the shards in rank order; export and parity checks
        only, the CD hot path never calls it). Every rank of the axis
        must call it together."""
        shards = gather(self.data, self.mesh, self.axis)  # [n, E_loc, d]
        flat = shards.reshape(-1, self.dim)
        rows = self.spec.sharded_row_of(np.arange(self.spec.num_entities, dtype=np.int64))
        return flat.index_select(0, torch.as_tensor(rows, device=flat.device))

    def __array__(self, dtype=None):
        host = overlap.device_get(self.to_global())
        return np.asarray(host, dtype) if dtype is not None else np.asarray(host)

    def per_device_bytes(self) -> int:
        return per_device_bytes(self.data)


def per_device_bytes(*values) -> int:
    """Bytes this rank's device holds across the given tensors /
    ShardedREBanks (each rank holds one device; the reference's maximum
    over devices is the maximum of this over ranks)."""
    total = 0
    for v in values:
        t = v.data if isinstance(v, ShardedREBank) else v
        total += int(t.numel() * t.element_size())
    return total


# ---------------------------------------------------------------------------
# pod view of a RandomEffectDataset
# ---------------------------------------------------------------------------


@dataclass
class _PodBlock:
    """One bucket's block on this rank: the bucket's entities that hash to
    this rank, in the reference's order, padded to ``e_blk`` (the widest
    shard of the bucket). ``kind`` is the solver the replicated path would
    pick for the whole bucket."""

    kind: str
    num_real: int  # real entities across all shards (tracker accounting)
    num_mine: int  # real entities of this rank: lanes 0..num_mine-1
    lrow: Tensor
    valid: Tensor
    ix: Tensor
    v: Tensor
    lab: Tensor
    w: Tensor
    offslot: Tensor


def shard_blocks(codes: np.ndarray, n_dev: int):
    """-> (owner shard, position within the shard's block, e_blk) for a
    bucket's entity codes: the reference's per-shard block layout, the
    positions by a stable sort."""
    sh = entity_shard_of(codes, n_dev)
    pos = rank_within(sh, np.ones(len(codes), bool))
    counts = np.bincount(sh, minlength=n_dev) if len(codes) else np.zeros(n_dev, np.int64)
    return sh, pos, max(1, int(counts.max()))


class _PodView:
    """The entity-hash-sharded view of one RandomEffectDataset on this
    rank: the residual router, this rank's scoring slots and its solver
    blocks. Built host-side once per (dataset, mesh) from the full tables;
    only this rank's shard is uploaded. ``axis`` names the entity axis (the
    unified (grid, entity) mesh passes it; the view serves every member)."""

    def __init__(self, mesh, dataset: RandomEffectDataset, base_problem,
                 axis: Optional[str] = None):
        self.mesh = mesh
        axis = axis or mesh.axis_names[0]
        self.axis = axis
        n_dev = mesh.size(axis)
        me = mesh.index(axis)
        self.n_dev = n_dev
        self.num_rows = int(dataset.row_entity_codes.shape[0])
        self.spec = EntityShardSpec(n_dev, dataset.num_entities)
        e_loc = self.spec.rows_per_shard
        dev = mesh.device

        codes = np.asarray(dataset.row_entity_codes, np.int64)
        self.router = PodResidualRouter(mesh, codes, axis=axis)

        # scoring slots: every valid row's features at its owner's
        # (source, rank) slot; active AND passive rows, as score_random_effect
        gid = self.router.slot_row[me]
        s_valid = gid >= 0
        safe = np.maximum(gid, 0)
        slot_ix = np.where(s_valid[:, None], dataset.row_local_indices[safe], 0)
        slot_v = np.where(s_valid[:, None], dataset.row_local_values[safe], 0.0)
        slot_lrow = np.where(s_valid, self.spec.local_of(np.where(s_valid, codes[safe], 0)), e_loc)
        self.slot_ix = torch.as_tensor(slot_ix, device=dev).long()
        self.slot_v = torch.as_tensor(slot_v.astype(np.asarray(dataset.row_local_values).dtype),
                                      device=dev)
        self.slot_lrow = torch.as_tensor(slot_lrow, device=dev).long()
        self.slot_valid = torch.as_tensor(s_valid, device=dev)

        # solver blocks: a sample's residual arrives through its row's
        # scoring slot, on the same rank (the sample's entity owns the slot)
        slot_of_row = self.router.slot_of_row
        self.blocks: List[_PodBlock] = []
        d_local = dataset.local_dim
        for bucket in dataset.buckets:
            kind = base_problem._bucket_kind(bucket, d_local)
            b_codes = np.asarray(bucket.entity_codes, np.int64)
            sh, pos, e_blk = shard_blocks(b_codes, n_dev)
            mine = np.nonzero(sh == me)[0]
            mine = mine[np.argsort(pos[mine], kind="stable")]
            n_mine = len(mine)
            S, kk = bucket.capacity, bucket.indices.shape[2]

            def block(a, fill=0, dtype=None):
                a = np.asarray(a)
                out = np.full((e_blk,) + a.shape[1:], fill, dtype or a.dtype)
                out[:n_mine] = a[mine]
                return torch.as_tensor(out, device=dev)

            gids = bucket.row_index
            offslot = np.where(gids >= 0, slot_of_row[np.maximum(gids, 0)], -1)
            lrow = np.full(e_blk, e_loc, np.int64)
            lrow[:n_mine] = self.spec.local_of(b_codes[mine])
            valid = np.zeros(e_blk, bool)
            valid[:n_mine] = True
            self.blocks.append(_PodBlock(
                kind=kind,
                num_real=bucket.num_entities,
                num_mine=n_mine,
                lrow=torch.as_tensor(lrow, device=dev),
                valid=torch.as_tensor(valid, device=dev),
                ix=block(bucket.indices).long(),
                v=block(bucket.values),
                lab=block(bucket.labels),
                w=block(bucket.weights),
                offslot=block(offslot, fill=-1, dtype=np.int64),
            ))
            assert self.blocks[-1].ix.shape == (e_blk, S, kk)

    def per_device_data_bytes(self) -> int:
        """Bytes of this rank's staged solver blocks and scoring slots."""
        arrays = [self.slot_ix, self.slot_v, self.slot_lrow, self.slot_valid]
        for b in self.blocks:
            arrays += [b.lrow, b.valid, b.ix, b.v, b.lab, b.w, b.offslot]
        return per_device_bytes(*arrays)


# ---------------------------------------------------------------------------
# the sharded programs, as each rank's code
# ---------------------------------------------------------------------------


def _block_stats(iters, reasons, valid: Tensor) -> Tensor:
    """[2 + R] int64: the sum and max of the valid lanes' iterations and
    their reason counts (pad lanes fall into an extra bin)."""
    it = torch.as_tensor(iters, device=valid.device).reshape(-1).to(torch.int64)
    rs = torch.as_tensor(reasons, device=valid.device).reshape(-1).to(torch.int64)
    vi = torch.where(valid, it, 0)
    r = torch.where(valid, rs, _N_REASONS)
    counts = torch.bincount(r, minlength=_N_REASONS + 1)[:_N_REASONS]
    return torch.cat([vi.sum().reshape(1), vi.max().reshape(1), counts])


def _reduce_stats(local: Tensor, mesh, axis: str) -> Tensor:
    """Per-block stat vectors [B, 2 + R] of every rank -> the axis-wide
    ones: iteration sums and reason counts summed, maxima maxed (the
    reference's integer psum / pmax, as one all-gather)."""
    parts = gather(local, mesh, axis)  # [n, B, 2 + R]
    out = parts.sum(dim=0)
    out[:, 1] = parts[:, :, 1].max(dim=0).values
    return out


def _tracker_finalize(total: int, num_entities: Optional[int] = None):
    def _finalize(all_stats):
        all_stats = np.asarray(all_stats)
        count_vec = all_stats[:, 2:].sum(axis=0)
        return RandomEffectTracker(
            num_entities=total if num_entities is None else num_entities,
            iterations_mean=int(all_stats[:, 0].sum()) / max(total, 1),
            iterations_max=int(all_stats[:, 1].max()),
            reason_counts={
                CONVERGENCE_REASON_NAMES.get(code, "?"): int(cnt)
                for code, cnt in enumerate(count_vec) if cnt
            },
        )

    return _finalize


def _slot_offsets(offslot: Tensor, slots: Tensor) -> Tensor:
    return torch.where(offslot >= 0, slots[offslot.clamp_min(0)], 0.0)


def _gather_rows(bank_l: Tensor, lrow: Tensor, valid: Tensor) -> Tensor:
    safe = lrow.clamp_max(bank_l.shape[0] - 1)
    return torch.where(valid[:, None], bank_l.index_select(0, safe), 0.0)


def _score_slots(bank_l: Tensor, slot_lrow, slot_ix, slot_v, slot_valid) -> Tensor:
    """This rank's slot scores against its local bank rows."""
    w_rows = bank_l.index_select(0, slot_lrow.clamp_max(bank_l.shape[0] - 1))
    s = entity_products.row_dot(slot_v.to(bank_l.dtype), torch.gather(w_rows, 1, slot_ix))
    return torch.where(slot_valid, s, 0.0)


# ---------------------------------------------------------------------------
# the sharded problem
# ---------------------------------------------------------------------------


class PodRandomEffectProblem:
    """Entity-sharded twin of RandomEffectOptimizationProblem: the same
    solvers and convergence, but the bank, variances and per-entity data
    live sharded over the entity axis, residuals arrive by one all-to-all,
    and each rank solves only the entities it owns. Every rank of the mesh
    calls each method together with the same arguments.

    ``base`` must carry ``mesh=None``: the pod layer owns placement; the
    base problem gives the solvers, the solver-kind choice and the
    regularization."""

    def __init__(self, base: RandomEffectOptimizationProblem, mesh):
        if base.mesh is not None:
            raise ValueError(
                "PodRandomEffectProblem wraps a mesh-less base problem; "
                "the entity mesh is owned by the pod layer"
            )
        self.base = base
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        if self.axis != ENTITY_AXIS:
            raise ValueError(
                f"pod mesh must carry the {ENTITY_AXIS!r} axis, got "
                f"{mesh.axis_names!r}"
            )
        self.num_shards = mesh.size(self.axis)
        self._views: Dict[int, tuple] = {}

    def spec_for(self, dataset: RandomEffectDataset) -> EntityShardSpec:
        return EntityShardSpec(self.num_shards, dataset.num_entities)

    def init_bank(self, dataset: RandomEffectDataset, dtype=torch.float32) -> ShardedREBank:
        return ShardedREBank.zeros(self.mesh, self.spec_for(dataset), dataset.local_dim,
                                   dtype=dtype, axis=self.axis)

    def pod_view(self, dataset: RandomEffectDataset) -> _PodView:  # photon: entropy(id-keyed view memo; weakref-pinned, in-memory only)
        """The sharded view, built once per dataset (kept while it lives)."""
        key = id(dataset)
        hit = self._views.get(key)
        if hit is not None and hit[0]() is dataset:
            return hit[1]
        view = _PodView(self.mesh, dataset, self.base)
        cache = self._views
        ref = weakref.ref(dataset, lambda _, k=key, c=cache: c.pop(k, None))
        cache[key] = (ref, view)
        return view

    def prepare(self, dataset: RandomEffectDataset) -> None:
        """Stage the pod view (routing tables, blocks, scoring slots)."""
        self.pod_view(dataset)

    def _coerce_bank(self, bank, dataset) -> ShardedREBank:
        if isinstance(bank, ShardedREBank):
            return bank
        # a whole [E, d] bank (warm start / checkpoint restore): shard it
        return ShardedREBank.from_global(self.mesh, self.spec_for(dataset), bank, axis=self.axis)

    def update_bank(
        self,
        bank,
        dataset: RandomEffectDataset,
        residual_offsets: Optional[Tensor] = None,
        with_variances: bool = False,
        defer_tracker: bool = False,
    ):
        """One cross-replica sharded bank update. ``residual_offsets`` is
        the row-aligned ``[n]`` offsets-plus-residual vector, whole on
        every rank (the CD loop always has it); the routed slots are the
        offset currency, so it is required."""
        if residual_offsets is None:
            raise ValueError(
                "the pod update requires the row-aligned residual/offsets "
                "vector; pass dataset offsets (+ residual) like the CD "
                "loop does"
            )
        view = self.pod_view(dataset)
        bank = self._coerce_bank(bank, dataset)
        l1, l2 = self.base.regularization.split(self.base.reg_weight)
        dt = bank.data.dtype
        residual_offsets = torch.as_tensor(residual_offsets, device=bank.data.device).to(dt)
        slots = view.router.route_in(residual_offsets)  # hop 1
        data = bank.data.clone()
        var_data = torch.zeros_like(data) if with_variances else None
        n_reals: List[int] = []
        stat_vecs: List[Tensor] = []
        for blk in view.blocks:
            off = _slot_offsets(blk.offslot, slots)
            v, lab, w = blk.v.to(dt), blk.lab.to(dt), blk.w.to(dt)
            sl = _gather_rows(data, blk.lrow, blk.valid)
            new_sl, iters, reasons = self.base._solve(blk.kind, sl, blk.ix, v, lab, off, w, l1, l2)
            m = blk.num_mine
            if m:
                data.index_copy_(0, blk.lrow[:m], new_sl[:m])
            if with_variances:
                hd = self.base._hdiag(new_sl, blk.ix, v, lab, off, w, l2)
                if m:
                    var_data.index_copy_(0, blk.lrow[:m], (1.0 / (hd + _VARIANCE_EPSILON))[:m])
            n_reals.append(blk.num_real)
            stat_vecs.append(_block_stats(iters, reasons, blk.valid))
        new_bank = ShardedREBank(self.mesh, bank.spec, data, self.axis)
        if stat_vecs:
            stats = _reduce_stats(torch.stack(stat_vecs), self.mesh, self.axis)
            deferred = overlap.Deferred(stats, _tracker_finalize(sum(n_reals)))
            if defer_tracker and not deferred.done:
                tracker = LazyRandomEffectTracker(deferred)
            else:
                tracker = deferred.result()
        else:
            tracker = RandomEffectTracker(0, 0.0, 0, {})
        if with_variances:
            return new_bank, tracker, ShardedREBank(self.mesh, bank.spec, var_data, self.axis)
        return new_bank, tracker

    def update_segment(
        self,
        bank: ShardedREBank,
        entity_codes: np.ndarray,
        arrays: Dict[str, np.ndarray],
        offsets: np.ndarray,
        *,
        kind: str,
    ):
        """Sharded update of ONE streamed bucket segment
        (``game/streaming.SpilledREBuckets``): the segment's entities split
        by the entity hash, and this rank stages and solves only its own
        shard. The residual is already folded into ``offsets`` host-side
        (the out-of-core contract). -> (new bank, this rank's stat vector);
        :meth:`segment_tracker` reduces the stat vectors over the ranks."""
        n_dev = self.num_shards
        me = self.mesh.index(self.axis)
        spec = bank.spec
        codes = np.asarray(entity_codes, np.int64)
        sh, pos, e_blk = shard_blocks(codes, n_dev)
        mine = np.nonzero(sh == me)[0]
        mine = mine[np.argsort(pos[mine], kind="stable")]
        m = len(mine)
        dev = bank.data.device
        dt = bank.data.dtype

        def block(a, dtype=None):
            a = np.asarray(a)
            out = np.zeros((e_blk,) + a.shape[1:], dtype or a.dtype)
            out[:m] = a[mine]
            return torch.as_tensor(out, device=dev)

        lrow = np.full(e_blk, spec.rows_per_shard, np.int64)
        lrow[:m] = spec.local_of(codes[mine])
        valid = np.zeros(e_blk, bool)
        valid[:m] = True
        lrow_t = torch.as_tensor(lrow, device=dev)
        valid_t = torch.as_tensor(valid, device=dev)
        l1, l2 = self.base.regularization.split(self.base.reg_weight)
        data = bank.data.clone()
        sl = _gather_rows(data, lrow_t, valid_t)
        new_sl, iters, reasons = self.base._solve(
            kind, sl, block(arrays["ix"]).long(), block(arrays["v"]).to(dt),
            block(arrays["lab"]).to(dt), block(offsets, np.float32).to(dt),
            block(arrays["wgt"]).to(dt), l1, l2,
        )
        if m:
            data.index_copy_(0, lrow_t[:m], new_sl[:m])
        return (ShardedREBank(self.mesh, spec, data, self.axis),
                _block_stats(iters, reasons, valid_t))

    def segment_tracker(self, stat_vecs, num_entities: int, defer: bool = True):
        """Fold the segments' stat vectors (reduced over the ranks here, in
        one all-gather) into one RandomEffectTracker, deferred for the CD
        loop's batched readback."""
        stats = _reduce_stats(torch.stack(list(stat_vecs)), self.mesh, self.axis)
        deferred = overlap.Deferred(
            stats, _tracker_finalize(max(num_entities, 1), num_entities)
        )
        if defer and not deferred.done:
            return LazyRandomEffectTracker(deferred)
        return deferred.result()

    def score_chunk(self, bank: ShardedREBank, codes, ix, v, valid) -> Tensor:
        """``[R]`` scores of one streamed chunk (whole on every rank): each
        rank scores the rows it owns and a sum over the ranks in rank order
        assembles the row vector (exact: every other rank adds 0). The
        bank never leaves its shards."""
        dev = bank.data.device
        n_dev = self.num_shards
        me = self.mesh.index(self.axis)
        codes = torch.as_tensor(np.asarray(codes), device=dev).long()
        valid = torch.as_tensor(np.asarray(valid), device=dev)
        mine = valid & (ownership.owner_of(codes, n_dev) == me)
        lrow = ownership.local_row_of(codes.clamp_min(0), n_dev).clamp_max(bank.data.shape[0] - 1)
        w_rows = bank.data.index_select(0, torch.where(mine, lrow, 0))
        ix = torch.as_tensor(np.asarray(ix), device=dev).long()
        v = torch.as_tensor(np.asarray(v), device=dev).to(bank.data.dtype)
        s = entity_products.row_dot(v, torch.gather(w_rows, 1, ix))
        s = torch.where(mine, s, 0.0)
        return sum_in_rank_order(s, self.mesh.groups[self.axis]) if n_dev > 1 else s

    def score(self, bank, dataset: RandomEffectDataset) -> Tensor:
        """Row-aligned ``[n]`` scores, whole on every rank: owners score
        their slots locally, the reverse all-to-all returns each score to
        its row's rank, and the row blocks are gathered in rank order."""
        view = self.pod_view(dataset)
        bank = self._coerce_bank(bank, dataset)
        s = _score_slots(bank.data, view.slot_lrow, view.slot_ix, view.slot_v, view.slot_valid)
        return view.router.route_out(s)

    def regularization_term_device(self, bank) -> Tensor:
        """The reg term over the sharded bank: each rank's partial summed
        in rank order (padding rows are zeros), a device scalar that joins
        the CD iteration's one batched readback."""
        data = bank.data if isinstance(bank, ShardedREBank) else bank
        l1, l2 = self.base.regularization.split(self.base.reg_weight)
        term = 0.5 * l2 * (data * data).sum()
        if l1:
            term = term + l1 * data.abs().sum()
        if not isinstance(bank, ShardedREBank):
            return term
        if self.num_shards == 1:
            return term
        return sum_in_rank_order(term, self.mesh.groups[self.axis])

    def regularization_term(self, bank) -> float:
        return float(overlap.device_get(self.regularization_term_device(bank)))


class PodRandomEffectModel(RandomEffectModel):
    """RandomEffectModel whose bank lives SHARDED: ``bank`` / ``variances``
    materialize the whole bank lazily (export, validation scoring; an
    all-gather, so every rank reads them together), while the pod
    coordinate trains and scores against ``sharded_bank``. A subclass, so
    model files and the drivers' validation scorer take it as it is."""

    # not a dataclass: bank / variances are lazy properties over the
    # sharded state instead of fields
    def __init__(
        self,
        sharded_bank: ShardedREBank,
        re_dataset: RandomEffectDataset,
        random_effect_type: str,
        feature_shard_id: str,
        variances_sharded: Optional[ShardedREBank] = None,
    ):
        self.sharded_bank = sharded_bank
        self.re_dataset = re_dataset
        self.random_effect_type = random_effect_type
        self.feature_shard_id = feature_shard_id
        self.variances_sharded = variances_sharded
        self._bank_cache: Optional[Tensor] = None
        self._var_cache: Optional[Tensor] = None

    @property
    def bank(self) -> Tensor:
        if self._bank_cache is None:
            self._bank_cache = self.sharded_bank.to_global()
        return self._bank_cache

    @property
    def variances(self) -> Optional[Tensor]:
        if self.variances_sharded is None:
            return self._var_cache
        if self._var_cache is None:
            self._var_cache = self.variances_sharded.to_global()
        return self._var_cache

    @variances.setter
    def variances(self, value) -> None:
        self._var_cache = value

    def __repr__(self) -> str:
        return (f"PodRandomEffectModel({self.random_effect_type!r}, "
                f"{self.sharded_bank.spec}, dim={self.sharded_bank.dim})")

    def to_random_effect_model(self) -> RandomEffectModel:
        """The materialized whole twin (model files, checkpoints)."""
        return RandomEffectModel(
            self.bank, self.re_dataset, self.random_effect_type, self.feature_shard_id,
            variances=self.variances,
        )
