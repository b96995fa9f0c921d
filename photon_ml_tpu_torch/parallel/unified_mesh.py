"""Unified (grid × entity) mesh-shape policy (port of
``photon_ml_tpu/parallel/unified_mesh.py``), ranks counted as devices.

One mesh, four axis roles (``parallel/mesh.py``):

- ``data``: example rows. On the unified mesh the ENTITY axis doubles as
  the row axis for row-aligned currency, exactly like the pod path.
- ``model``: feature blocks; ``feature_blocks`` records the requested
  count; the unified GAME grid keeps its fixed-effect solves replicated.
- ``entity``: hash-sharded random-effect banks (``game/pod.py``).
- ``grid``: λ-grid members: a ``[G, ...]`` bank is split over the grid
  rows, each row holding ``G_loc = ceil(G / grid_rows)`` members.

:func:`plan_mesh` is the driver policy (a table, no process group);
:func:`resolve_mesh` adds this rank's ``ProcessMesh``. Given the ranks,
the grid size G, the entity shard count N and one member's bank bytes, it
picks ``(grid_rows, entity_shards)``, preferring grid rows that divide G
(no padding members), and reports the bytes per device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, GRID_AXIS, make_mesh

__all__ = ["MeshPlan", "plan_mesh", "resolve_mesh"]


@dataclass(frozen=True)
class MeshPlan:
    """Resolved unified-mesh shape for one λ-grid × entity-sharded run.

    ``mesh`` (this rank's ``ProcessMesh``, None for a bare plan) carries
    the axes ``(grid, entity)`` with shape ``(grid_rows, entity_shards)``
    over blocks of ``grid_rows * entity_shards`` ranks. The bank's member
    axis is padded to ``grid_padded = grid_rows * members_per_row``
    (padding members run inert copies of the last λ and are dropped at
    unpack)."""

    mesh: object
    grid_size: int
    grid_rows: int
    entity_shards: int
    feature_blocks: int
    members_per_row: int
    per_device_bank_bytes: int
    budget_bytes: Optional[int]

    @property
    def grid_padded(self) -> int:
        return self.grid_rows * self.members_per_row

    @property
    def fits_budget(self) -> bool:
        return self.budget_bytes is None or self.per_device_bank_bytes <= self.budget_bytes

    def members_of_row(self, row: int) -> range:
        """The padded member indices held by grid row ``row``."""
        g = self.members_per_row
        return range(row * g, (row + 1) * g)

    def pad_members(self, values):
        """Pad a per-member list to ``grid_padded`` by repeating the last
        member (inert duplicates, dropped at unpack)."""
        values = list(values)
        if not values:
            raise ValueError("empty member list")
        while len(values) < self.grid_padded:
            values.append(values[-1])
        return values


def plan_mesh(
    num_devices: int,
    grid_size: int = 1,
    entity_shards: Optional[int] = None,
    feature_blocks: Optional[int] = None,
    budget: Optional[int] = None,
    *,
    member_bank_bytes: int = 0,
) -> MeshPlan:
    """The reference's ``resolve_mesh`` policy over ``num_devices`` ranks:
    the entity axis gets exactly ``entity_shards`` ranks (default 1; -1
    all), the grid axis the largest row count that fits the remaining
    ranks and divides G when any divisor fits. Under (grid, entity)
    placement each device holds ``G_loc * member_bank_bytes / N``."""
    n_dev = int(num_devices)
    if grid_size < 1:
        raise ValueError(f"grid_size must be >= 1, got {grid_size}")
    n_ent = 1 if entity_shards is None or entity_shards == 0 else (
        n_dev if entity_shards == -1 else int(entity_shards)
    )
    if not 1 <= n_ent <= n_dev:
        raise ValueError(
            f"entity_shards {entity_shards} out of range for {n_dev} visible devices"
        )
    blocks = 1 if feature_blocks is None else int(feature_blocks)
    if blocks < 1:
        raise ValueError(f"feature_blocks must be >= 1, got {feature_blocks}")
    usable = max(1, n_dev // n_ent)
    divisors = [r for r in range(1, usable + 1) if grid_size % r == 0]
    grid_rows = max(divisors) if divisors else min(usable, grid_size)
    members_per_row = -(-grid_size // grid_rows)
    per_device = (members_per_row * int(member_bank_bytes)) // max(n_ent, 1)
    return MeshPlan(
        mesh=None,
        grid_size=int(grid_size),
        grid_rows=int(grid_rows),
        entity_shards=int(n_ent),
        feature_blocks=blocks,
        members_per_row=int(members_per_row),
        per_device_bank_bytes=int(per_device),
        budget_bytes=None if budget is None else int(budget),
    )


def resolve_mesh(
    num_devices: Optional[int] = None,
    grid_size: int = 1,
    entity_shards: Optional[int] = None,
    feature_blocks: Optional[int] = None,
    budget: Optional[int] = None,
    *,
    member_bank_bytes: int = 0,
    device=None,
    backend: str = "gloo",
) -> MeshPlan:
    """:func:`plan_mesh` over the processes (``num_devices`` defaults to
    the process count), with this rank's ``(grid, entity)`` mesh. Every
    rank calls it with the same arguments. A plan over fewer ranks than
    processes makes blocks of consecutive ranks, each its own mesh (so
    its size must divide the process count)."""
    from dataclasses import replace

    from photon_ml_tpu_torch.parallel import multihost

    n = multihost.process_count() if num_devices is None else int(num_devices)
    plan = plan_mesh(n, grid_size, entity_shards, feature_blocks, budget,
                     member_bank_bytes=member_bank_bytes)
    mesh = make_mesh(
        (plan.grid_rows, plan.entity_shards), (GRID_AXIS, ENTITY_AXIS),
        device=device, backend=backend, replicas=True,
    )
    return replace(plan, mesh=mesh)
