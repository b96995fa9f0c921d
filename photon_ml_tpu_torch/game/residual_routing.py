"""Per-iteration residual routing over ranks (port of
``photon_ml_tpu/game/residual_routing.py``), the consumer of
``parallel.shuffle``.

Reference: every coordinate-descent sweep re-keys the residual scores from
rows to entity groups with a Spark shuffle
(RandomEffectDataSet.addScoresToOffsets, RandomEffectDataSet.scala:55-74).
Here rows are sharded over the mesh axis; ONE all-to-all routes each
row's residual to the rank that owns its entity's slot, and a local
scatter lands it where the solver reads it.

The port's coordinate descent holds whole row vectors on every rank, so
each rank sends only its own row block (rows ``[r * n_pad / n_dev, ...)``)
and the scores that come back are gathered in rank order. All routing
tables are static per (dataset, mesh): every rank builds the same host
tables from the full entity codes (the reference's one controller does
the same), then uploads only its own shard.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.game.random_effect_data import RandomEffectDataset
from photon_ml_tpu_torch.parallel.shuffle import entity_all_to_all, exchange, gather, row_block

Tensor = torch.Tensor


def rank_within(group_key: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Each valid element's rank among the valid elements with its key, in
    their order (0 where not valid): a stable sort, not a loop of masks."""
    rank = np.zeros(group_key.shape[0], np.int64)
    idx = np.nonzero(valid)[0]
    if idx.size:
        keys = group_key[idx]
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        first = np.searchsorted(sk, sk, side="left")
        rank[idx[order]] = np.arange(idx.size) - first
    return rank


class ResidualRouter:
    """Routes a row-aligned offsets vector to per-bucket entity slabs for
    the replicated bank's mesh path (``RandomEffectOptimizationProblem(
    mesh=)``): bucket ``b``'s entities are padded to ``n_dev * E_loc_b``
    and split contiguously, so entity position ``p`` lives on rank
    ``p // E_loc_b`` at local row ``p % E_loc_b``. Each rank holds one flat
    buffer of ``sum_b E_loc_b * S_b`` offset slots; bucket ``b``'s slab
    starts at ``self.starts[b]``."""

    def __init__(self, mesh, dataset: RandomEffectDataset, axis: Optional[str] = None):
        self.mesh = mesh
        self.axis = axis or mesh.axis_names[0]
        n_dev = mesh.size(self.axis)
        self.n_dev = n_dev
        self.index = mesh.index(self.axis)

        n = dataset.row_entity_codes.shape[0]
        self.num_rows = n
        n_pad = ((n + n_dev - 1) // n_dev) * n_dev
        self.num_rows_padded = n_pad

        dest_dev = np.full(n_pad, -1, np.int32)
        flat_pos = np.zeros(n_pad, np.int32)
        self.starts: List[int] = []
        self.e_locs: List[int] = []
        flat_len = 0
        for b in dataset.buckets:
            e_b, s_b = b.num_entities, b.capacity
            e_loc = -(-e_b // n_dev)
            self.starts.append(flat_len)
            self.e_locs.append(e_loc)
            ent, col = np.nonzero(b.row_index >= 0)
            rows = b.row_index[ent, col]
            dest_dev[rows] = (ent // e_loc).astype(np.int32)
            flat_pos[rows] = (flat_len + (ent % e_loc) * s_b + col).astype(np.int32)
            flat_len += e_loc * s_b
        self.flat_len = flat_len

        # exact static send capacity: the worst (source shard -> owner) count
        per_src = n_pad // n_dev
        worst = 1
        for s in range(n_dev):
            local = dest_dev[s * per_src:(s + 1) * per_src]
            local = local[local >= 0]
            if local.size:
                worst = max(worst, int(np.bincount(local, minlength=n_dev).max()))
        self.cap = ((worst + 7) // 8) * 8
        self.dest_dev = dest_dev
        self.flat_pos = flat_pos

        dev = mesh.device
        lo = self.index * per_src
        self._dest_dev = torch.as_tensor(dest_dev[lo:lo + per_src], device=dev).long()
        self._flat_pos = torch.as_tensor(flat_pos[lo:lo + per_src], device=dev).long()

    def route(self, offsets: Tensor) -> Tensor:
        """``[n]`` row offsets (whole, on every rank) -> this rank's
        ``[flat_len]`` slab buffer. One all-to-all and one local scatter;
        overflow is impossible (the capacities are exact counts)."""
        off = row_block(offsets, self.n_dev, self.index, self.num_rows_padded)
        shuffled = entity_all_to_all(
            self.mesh, self._dest_dev, (off, self._flat_pos), cap=self.cap, axis=self.axis,
        )
        vals, pos = shuffled.payload
        valid = shuffled.entity_codes >= 0
        idx = torch.where(valid, pos, self.flat_len)  # the trash slot
        buf = vals.new_zeros(self.flat_len + 1)
        buf[idx] = torch.where(valid, vals, 0.0)
        return buf[:self.flat_len]

    def bucket_slab(self, flat: Tensor, bucket_index: int, capacity: int) -> Tensor:
        """Bucket ``bucket_index``'s offsets slab of this rank's routed
        buffer -> ``[E_loc, S]``."""
        s = self.starts[bucket_index]
        e_loc = self.e_locs[bucket_index]
        return flat[s:s + e_loc * capacity].reshape(e_loc, capacity)


class PodResidualRouter:
    """Two-hop residual exchange for HASH-sharded entity banks
    (``game/pod.py``): rows are row-sharded over the axis, entity ``e``
    lives on shard ``e % n_dev``.

    Hop 1 (:meth:`route_in`): ONE all-to-all carries each row's residual to
    its entity's owner, into a static per-owner SLOT layout. Hop 2 (in the
    pod score): the owner scores its slots against its local bank rows and
    the same all-to-all, reversed, carries the scores back. The send
    position of every row (``owner * cap + rank``) doubles as its return
    position, since the all-to-all on ``[n_dev, cap]`` blocks is its own
    inverse.

    Tables (equal to the reference's): ``cap``, ``slot_row [owner, slot]``
    (global row id, -1 pad) and ``slot_of_row`` (each row's slot on its
    owner, -1 without one)."""

    def __init__(self, mesh, row_entity_codes, *, axis: Optional[str] = None):
        self.mesh = mesh
        self.axis = axis or mesh.axis_names[0]
        n_dev = mesh.size(self.axis)
        self.n_dev = n_dev
        self.index = mesh.index(self.axis)

        codes = np.asarray(row_entity_codes, np.int64)
        n = codes.shape[0]
        self.num_rows = n
        n_pad = ((n + n_dev - 1) // n_dev) * n_dev
        self.num_rows_padded = n_pad
        per_src = n_pad // n_dev
        owner = np.full(n_pad, -1, np.int64)
        owner[:n] = np.where(codes >= 0, ownership.owner_of(codes, n_dev), -1)
        src = np.arange(n_pad) // per_src
        valid = owner >= 0

        # rank of each row among same-owner rows of its source shard, and
        # the exact capacity: the worst (source, owner) count
        key = src * n_dev + np.maximum(owner, 0)
        rank = rank_within(key, valid)
        counts = np.bincount(key[valid], minlength=n_dev * n_dev) if valid.any() else np.zeros(1)
        cap = max(1, int(counts.max()))
        cap = ((cap + 7) // 8) * 8
        self.cap = cap
        self.num_slots = n_dev * cap  # per-owner received slot count

        send_pos = np.where(valid, owner * cap + rank, self.num_slots).astype(np.int32)
        slot_row = np.full((n_dev, self.num_slots), -1, np.int64)
        rows = np.nonzero(valid)[0]
        slot_row[owner[rows], src[rows] * cap + rank[rows]] = rows
        self.slot_row = slot_row
        self.slot_of_row = np.where(valid, src * cap + rank, -1).astype(np.int64)
        self.send_pos = send_pos

        lo = self.index * per_src
        self._send_pos = torch.as_tensor(send_pos[lo:lo + per_src], device=mesh.device).long()

    def route_in(self, row_values: Tensor) -> Tensor:
        """``[n]`` row values (whole, on every rank) -> this rank's
        ``[num_slots]`` owner-slot values. One all-to-all; no host
        round trip of the values."""
        vals = row_block(row_values, self.n_dev, self.index, self.num_rows_padded)
        buf = vals.new_zeros(self.num_slots + 1)
        buf[self._send_pos] = vals
        blocks = buf[:-1].reshape(self.n_dev, self.cap)
        return exchange(blocks, self.mesh, self.axis).reshape(-1)

    def route_out(self, slot_values: Tensor) -> Tensor:
        """This rank's ``[num_slots]`` owner-slot values -> ``[num_rows]``
        row-aligned values, whole on every rank: the reverse all-to-all
        lands each rank's row block (rows with no owner read 0), and the
        blocks are gathered in rank order."""
        back = exchange(
            slot_values.reshape(self.n_dev, self.cap), self.mesh, self.axis
        ).reshape(-1)
        pos = self._send_pos
        local = torch.where(pos < self.num_slots, back[pos.clamp_max(self.num_slots - 1)], 0.0)
        return gather(local, self.mesh, self.axis).reshape(-1)[: self.num_rows]
