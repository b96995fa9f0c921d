"""Entity re-sharding over ranks: the all-to-all analog of the reference's
shuffles (port of ``photon_ml_tpu/parallel/shuffle.py``), and the
transport every entity-sharded path uses.

Reference: RandomEffectDataSet groups rows by entity with a groupByKey /
partitionBy shuffle (RandomEffectDataSet.scala:169-243). The JAX package
makes it one ``lax.all_to_all`` inside ``shard_map``; here a rank's own
rows go through one ``dist.all_to_all_single`` on the axis's process
group, with the same static ``[n_dev, cap]`` blocks.

Ownership is ``entity_code % num_devices`` (``ownership.owner_of``, the
LongHashPartitioner analog). Rows with code < 0 (padding) go nowhere.

Static-shape contract: every rank sends exactly ``cap`` rows to every rank
(padding fills the gaps). Rows beyond ``cap`` for one target are DROPPED
and counted in ``dropped``, never silently; callers size ``cap`` from
host-side entity statistics (:func:`reshard_capacity`) and assert no drop.

Transport: the blocks go to the backend as they are, on the card or on
the CPU (gloo stages a CUDA tensor through the host itself; NCCL takes it
directly), counted in :data:`stats`. A failed exchange raises (the
backend's error); nothing falls back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.parallel import multihost

Tensor = torch.Tensor

# Counters of the transport, reset and read by callers: collectives run
# and bytes this rank sent.
stats = {"collectives": 0, "bytes": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def _count(t: Tensor) -> None:
    stats["collectives"] += 1
    stats["bytes"] += t.numel() * t.element_size()


def exchange(blocks: Tensor, mesh, axis: str) -> Tensor:
    """All-to-all over ``axis``: ``blocks [n_dev, cap, ...]`` where block j
    goes to rank j of the axis -> ``[n_dev, cap, ...]`` where block i came
    from rank i (the reference's ``lax.all_to_all(split_axis=0,
    concat_axis=0)``). It is its own inverse. One rank: the blocks."""
    if mesh.size(axis) == 1:
        return blocks
    src = blocks.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.groups[axis])
    _count(src)
    return out


def gather(t: Tensor, mesh, axis: str) -> Tensor:
    """Every rank's ``t`` of the axis stacked in rank order -> ``[n, ...]``
    (the reference's all-gather of a sharded value). One rank: ``t[None]``."""
    if mesh.size(axis) == 1:
        return t[None]
    _count(t)
    return multihost.gather_in_rank_order(t, mesh.groups[axis])


class ShuffledRows(NamedTuple):
    """Result of an entity re-shard on this rank: the rows it owns, grouped
    by source rank.

    - ``entity_codes [n_dev * cap]``: received codes, -1 on padding slots
    - ``payload``: tuple of ``[n_dev * cap, ...]`` tensors aligned with them
    - ``received [1]``: real rows that landed on this rank
    - ``dropped [1]``: rows this rank lost to capacity overflow on the send
      side (the sum over ranks is the global drop; 0 means lossless)
    """

    entity_codes: Tensor
    payload: tuple
    received: Tensor
    dropped: Tensor


def send_slots(codes: Tensor, n_dev: int, cap: int) -> Tensor:
    """Each local row's slot in the ``[n_dev * cap]`` send buffer
    (``owner * cap + rank among same-owner rows``, the rank by a stable
    sort), ``n_dev * cap`` (the trash slot) for padding and overflow."""
    n_loc = codes.shape[0]
    owner = torch.where(codes >= 0, ownership.owner_of(codes, n_dev), n_dev)
    order = torch.argsort(owner, stable=True)  # pads sort last
    sorted_owner = owner[order]
    first = torch.searchsorted(sorted_owner, sorted_owner)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_loc, device=codes.device) - first
    keep = (codes >= 0) & (rank < cap)
    return torch.where(keep, owner * cap + rank, n_dev * cap)


def _route(leaf: Tensor, slot: Tensor, keep: Tensor, n_slots: int, fill=0) -> Tensor:
    buf = leaf.new_full((n_slots + 1,) + tuple(leaf.shape[1:]), fill)
    mask = keep.reshape((-1,) + (1,) * (leaf.dim() - 1))
    buf[slot] = torch.where(mask, leaf, torch.full_like(leaf, fill))
    return buf[:n_slots]


def entity_all_to_all(
    mesh,
    entity_codes: Tensor,
    payload: Sequence[Tensor],
    *,
    cap: int,
    axis: str,
) -> ShuffledRows:
    """Re-shard this rank's rows to their owning rank (code % n_dev).
    ``entity_codes [n_loc]`` and every payload tensor ``[n_loc, ...]`` are
    this rank's rows; each rank receives ``n_dev * cap`` row slots (its
    share from every peer)."""
    n_dev = mesh.size(axis)
    n_slots = n_dev * cap
    codes = entity_codes.to(torch.int64)
    slot = send_slots(codes, n_dev, cap)
    keep = slot < n_slots
    send_codes = _route(codes, slot, keep, n_slots, fill=-1)
    dropped = ((codes >= 0) & ~keep).sum().reshape(1)

    def move(buf: Tensor) -> Tensor:
        blocks = buf.reshape((n_dev, cap) + tuple(buf.shape[1:]))
        return exchange(blocks, mesh, axis).reshape(buf.shape)

    recv_codes = move(send_codes)
    recv_payload = tuple(move(_route(leaf, slot, keep, n_slots)) for leaf in payload)
    return ShuffledRows(
        entity_codes=recv_codes,
        payload=recv_payload,
        received=(recv_codes >= 0).sum().reshape(1),
        dropped=dropped,
    )


def reshard_capacity(entity_codes, n_devices: int, *, slack: float = 1.25) -> int:
    """Host-side capacity sizing from actual entity statistics (the
    RandomEffectDataSetPartitioner's count pass): the most rows any
    (source shard, target rank) pair carries, times ``slack``, rounded up
    to 8."""
    codes = np.asarray(entity_codes)
    n = codes.shape[0]
    per_src = n // n_devices
    worst = 0
    for s in range(n_devices):
        local = codes[s * per_src:(s + 1) * per_src]
        local = local[local >= 0]
        if local.size:
            counts = np.bincount(ownership.owner_of(local, n_devices), minlength=n_devices)
            worst = max(worst, int(counts.max()))
    cap = int(np.ceil(worst * slack))
    return max(((cap + 7) // 8) * 8, 8)


def row_block(values: Tensor, n_dev: int, index: int, n_pad: Optional[int] = None) -> Tensor:
    """Rank ``index``'s block of a row vector padded with zeros to ``n_pad``
    (a multiple of ``n_dev``): rows ``[index * n_pad / n_dev, ...)``, the
    reference's row sharding over the axis."""
    n = values.shape[0]
    n_pad = n_pad if n_pad is not None else -(-n // n_dev) * n_dev
    per = n_pad // n_dev
    lo, hi = index * per, min((index + 1) * per, n)
    part = values[lo:hi] if lo < n else values[:0]
    if part.shape[0] < per:
        part = torch.cat([part, part.new_zeros((per - part.shape[0],) + tuple(part.shape[1:]))])
    return part
