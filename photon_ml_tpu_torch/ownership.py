"""The ONE entity-ownership rule, shared by every plane that places
entities on shards (a copy of ``photon_ml_tpu/ownership.py``, which
imports nothing of JAX; the port keeps its own).

Photon's entity sharding is everywhere: the pod trainer places bank
rows (``game/pod.py``), the in-jit shuffle routes rows to owners
(``parallel/shuffle.py``), the residual router builds its slot tables
(``game/residual_routing.py``), the serving loader keeps one shard of
a model (``serving/model_bank.py``), and the scatter/gather routing
tier (``serving/routing.py``) decides which shard-server answers for a
request's entities. All of them MUST agree, or a trained coefficient
silently serves from the wrong host — so the rule lives here, once:

- **owner**:     entity code ``e`` lives on shard ``e % num_shards``
  (the LongHashPartitioner analog — stable, stateless, balanced for
  hashed ids, and new entities never re-home old ones);
- **local row**: within its shard, ``e`` sits at local row
  ``e // num_shards``;
- **id lists**:  for a SORTED entity-id list (the model artifact
  layout), an id's code is its position, so shard ``s`` keeps exactly
  the ids at positions ``s, s + n, s + 2n, …``.

Everything is plain arithmetic so the same functions serve Python
ints, numpy arrays and tensors alike.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

__all__ = [
    "owner_of",
    "local_row_of",
    "rows_per_shard",
    "sharded_row_of",
    "validate_entity_shard",
    "owned_positions",
    "shard_entity_ids",
    "OWNERSHIP_RULE",
]

# the human/wire description, published by shard-server topology blocks
# so operators (and the router) can verify the deployed rule
OWNERSHIP_RULE = "entity_code % num_shards"


def owner_of(codes, num_shards: int):
    """Entity code -> owning shard (``e % n``). ``codes`` may be a
    Python int, a numpy array or a tensor — plain modulo, no dtype
    coercion."""
    return codes % num_shards


def local_row_of(codes, num_shards: int):
    """Entity code -> local bank row on its owning shard (``e // n``)."""
    return codes // num_shards


def rows_per_shard(num_entities: int, num_shards: int) -> int:
    """Local bank rows per shard (ceil division, >= 1 so empty banks
    stay valid device shapes)."""
    return -(-max(int(num_entities), 1) // int(num_shards))


def sharded_row_of(codes, num_shards: int, rows_per_shard: int):
    """Entity code -> row in the concatenated ``[n * E_loc, d]`` pod
    bank layout: shard-major, local-row-minor."""
    return owner_of(codes, num_shards) * rows_per_shard + local_row_of(
        codes, num_shards
    )


def validate_entity_shard(
    entity_shard: Optional[Tuple[int, int]]
) -> Optional[Tuple[int, int]]:
    """Normalize/validate an ``(shard_index, num_shards)`` pair (None
    passes through: "all entities")."""
    if entity_shard is None:
        return None
    s, n = entity_shard
    if not (isinstance(n, int) and n >= 1 and isinstance(s, int)
            and 0 <= s < n):
        raise ValueError(
            f"entity_shard must be (shard, num_shards) with "
            f"0 <= shard < num_shards, got {entity_shard!r}"
        )
    return (int(s), int(n))


def owned_positions(num_ids: int, shard: int, num_shards: int) -> range:
    """Positions of shard ``shard``'s entities in a sorted id list of
    length ``num_ids`` (position == entity code for artifact layouts)."""
    return range(int(shard), int(num_ids), int(num_shards))


def shard_entity_ids(
    ids: Sequence[str], entity_shard: Optional[Tuple[int, int]]
) -> List[str]:
    """One entity SHARD of a sorted entity-id list: an id's code is its
    position in the model's sorted order, and its owner is
    ``code % num_shards`` — identical to the training-side pod bank
    placement, so a server loading shard ``s`` of a pod-trained model
    holds exactly the rows device ``s`` trained. ``entity_shard`` is
    ``(shard_index, num_shards)`` or None (keep all)."""
    shard = validate_entity_shard(entity_shard)
    if shard is None:
        return list(ids)
    s, n = shard
    ids = list(ids)
    return [ids[i] for i in owned_positions(len(ids), s, n)]
