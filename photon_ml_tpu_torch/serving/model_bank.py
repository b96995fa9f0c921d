"""Device-resident GAME model bank for the online scoring path (port of
``photon_ml_tpu/serving/model_bank.py``).

The batch scorer (`cli/game_scoring_driver.py`) rebuilds dense
coefficient views per scoring DATASET (its entity codes come from the
data); a request path has no dataset — requests arrive one at a time
with raw entity ids. This module flips the layout to be model-centric:

- every fixed effect is ONE dense ``[d]`` device vector per shard;
- every random effect is a padded ``[E_pad, d]`` device bank whose row
  order is the model's own sorted entity ids, plus an O(1) host-side
  entity->row index (:class:`EntityRowIndex` — a dict for small banks,
  the ``utils/native_index`` mmap hash store above a size threshold);
- matrix factorizations are two ``[E_pad, K]`` latent banks.

Row values are built with the same index-map remap the batch scorer
uses, so a request row's dot product is bitwise-identical to the batch
path's — the serving parity tests assert exactly that.

``E_pad`` rounds the entity axis up to ``entity_pad_to`` so a new model
generation with a few more entities keeps the SAME device shapes: the
hot-swap path (`serving/swap.py`) can then copy the new values into the
old generation's tensors in place instead of holding two banks on the
card, and the CUDA graphs captured over those tensors stay valid.

The ``spec`` tuple is the bank's program signature — coordinate kinds,
order and shapes — and keys the program cache in `serving/programs.py`:
same signature, same programs.

Every builder takes ``device``: ``None`` is the CUDA card (raising
without one), ``"cpu"`` the CPU, and ``False`` keeps host numpy arrays
(the staging half of a hot swap, placed later on the serving bank's
device).
"""

from __future__ import annotations

import os
import subprocess
import threading
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "EntityRowIndex",
    "ModelBank",
    "build_model_bank",
    "bank_from_arrays",
    "place_on_device",
    "shard_entity_ids",
    "DEFAULT_ENTITY_PAD",
]

DEFAULT_ENTITY_PAD = 256
# Below this many entities a Python dict wins (no store build); above it
# the native mmap store keeps the host index O(1) without a GB-scale
# dict. Overridable for tests via the build functions' argument.
NATIVE_INDEX_THRESHOLD = 100_000
ENV_NATIVE_THRESHOLD = "PHOTON_SERVING_NATIVE_INDEX_MIN"

# ``device`` of the builders: a device, or False for host numpy arrays
BankDevice = Union[DeviceLike, bool]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _native_threshold(explicit: Optional[int]) -> int:
    if explicit is not None:
        return explicit
    env = os.environ.get(ENV_NATIVE_THRESHOLD, "").strip()
    return int(env) if env else NATIVE_INDEX_THRESHOLD


# One entity SHARD of a sorted entity-id list, by the shared ownership
# rule (photon_ml_tpu_torch/ownership.py), re-exported here because the
# serving loaders are where callers look for it.
shard_entity_ids = ownership.shard_entity_ids


class EntityRowIndex:
    """O(1) entity id -> bank row for one random-effect type.

    Small banks use a plain dict; banks at or above ``native_threshold``
    entities build a ``utils/native_index`` mmap store (hash-partitioned
    open addressing over ``native/index_store.cpp``) so the host-side
    index costs mmap pages instead of a Python dict over millions of ids.
    Lookups are lock-free either way (both structures are immutable
    after build).

    ``shard``: when this index covers ONE entity shard of a sharded
    GAME model (``(shard_index, num_shards)``), ``ids`` is the owned
    subset and every other entity resolves to row -1 — those requests
    score FE-only through the batcher's masked-row semantics.
    """

    def __init__(
        self,
        ids: Sequence[str],
        *,
        native_threshold: Optional[int] = None,
        shard: Optional[Tuple[int, int]] = None,
    ):
        self.shard = shard
        self.ids: List[str] = list(ids)
        self.num_entities = len(self.ids)
        self._store = None
        self._dict: Optional[Dict[str, int]] = None
        if self.num_entities >= _native_threshold(native_threshold):
            try:
                self._store = _build_native_store(self.ids)
            except (OSError, subprocess.SubprocessError):
                self._store = None  # no g++ to build the store: dict
        if self._store is None:
            self._dict = {v: i for i, v in enumerate(self.ids)}

    @property
    def backend(self) -> str:
        return "native" if self._store is not None else "dict"

    def row_of(self, entity_id: str) -> int:
        """Bank row for an entity id; -1 when the model has no entity
        (the request scores 0 through that coordinate, matching the
        batch scorer's masked-code semantics)."""
        if self._store is not None:
            return int(self._store.get_index(entity_id))
        return self._dict.get(entity_id, -1)

    def rows_of(self, entity_ids: Sequence[str]) -> np.ndarray:
        if self._store is not None:
            return self._store.get_indices(entity_ids).astype(np.int32)
        d = self._dict
        return np.fromiter(
            (d.get(e, -1) for e in entity_ids),
            dtype=np.int32,
            count=len(entity_ids),
        )


_STORE_LOCK = threading.Lock()
_STORE_SEQ = 0


def _build_native_store(ids: Sequence[str]):
    """One mmap store whose local indices ARE the bank rows (build_store
    assigns 0..n-1 in the order given). Lives in a registered spill dir
    so driver exits sweep it like every other spill artifact."""
    import tempfile

    from photon_ml_tpu_torch.io.streaming import register_spill_dir
    from photon_ml_tpu_torch.utils.native_index import (
        NativeIndexStore,
        build_store,
    )

    global _STORE_SEQ
    with _STORE_LOCK:
        _STORE_SEQ += 1
        seq = _STORE_SEQ
    d = tempfile.mkdtemp(prefix="photon-serving-eindex-")
    register_spill_dir(d)
    path = os.path.join(d, f"entity-rows-{seq}.pidx")
    build_store(path, ids)
    return NativeIndexStore(path)


@dataclass
class ModelBank:
    """One loaded model generation, device-resident.

    ``spec`` is the hashable program signature (kind, name, id types and
    shapes per coordinate, in scoring order); ``arrays`` maps coordinate
    name -> tensor(s) in the exact layout the spec promises (numpy
    arrays while ``device`` is None: a host staging bank). Two banks
    with equal specs run the same programs.
    """

    generation: int
    spec: tuple
    arrays: Dict[str, object]
    entity_rows: Dict[str, EntityRowIndex]
    index_maps: Mapping[str, object]
    shard_widths: Dict[str, int]
    # flipped by the swap path after this generation's tensors were
    # refreshed in place for its successor — using a retired bank is a bug
    retired: bool = False
    model_id: str = ""
    # random-effect id types whose bank is unusable for THIS generation
    # (poisoned artifact slice, repeated row-resolution failures):
    # requests touching them score FE-ONLY with a degraded flag instead
    # of failing. Per-generation by construction — a hot swap installs a
    # fresh bank with an empty set.
    quarantined_re_types: set = None  # set in __post_init__
    # where ``arrays`` live; None while they are host numpy arrays
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.quarantined_re_types is None:
            self.quarantined_re_types = frozenset()
        # serializes quarantine WRITERS (operator op on a connection
        # thread vs the dispatcher's auto-quarantine): without it the
        # copy-on-write below could lose one of two racing updates
        self._quarantine_lock = threading.Lock()

    def quarantine_re(self, re_type: str) -> None:
        """Mark one random-effect coordinate unusable for this
        generation; the batcher degrades affected rows to FE-only.

        Copy-on-write publish under a writer lock: writers race
        (operator op on a connection thread, the dispatcher's
        auto-quarantine), while the dispatcher READS the set per batch
        — so writers serialize on ``_quarantine_lock`` and publish a
        fresh frozenset as one reference assignment. Readers take no
        lock: they see the old set or the new one, never a set
        mid-mutation."""
        if re_type not in self.re_types:
            raise ValueError(
                f"unknown random-effect type {re_type!r}; "
                f"known: {self.re_types}"
            )
        with self._quarantine_lock:
            self.quarantined_re_types = (
                frozenset(self.quarantined_re_types) | {re_type}
            )

    @property
    def used_shards(self) -> Tuple[str, ...]:
        """Feature shards the spec actually scores. ``shard_widths``
        may cover MORE shards than the model references (an FE-only
        model served under a multi-shard request config): requests
        still carry those features, but the program inputs — and
        therefore batch assembly — only see the spec's shards."""
        shards = []
        for entry in self.spec:
            sid = (
                entry[2] if entry[0] == "fe"
                else entry[3] if entry[0] == "re"
                else None
            )
            if sid is not None and sid not in shards:
                shards.append(sid)
        return tuple(shards)

    @property
    def re_types(self) -> Tuple[str, ...]:
        types = []
        for entry in self.spec:
            if entry[0] == "re" and entry[2] not in types:
                types.append(entry[2])
            elif entry[0] == "mf":
                for t in (entry[2], entry[3]):
                    if t not in types:
                        types.append(t)
        return tuple(types)

    def entity_row(self, re_type: str, entity_id: str) -> int:
        return self.entity_rows[re_type].row_of(entity_id)

    def device_bytes(self) -> int:
        total = 0
        for v in self.arrays.values():
            for a in v if isinstance(v, tuple) else (v,):
                total += (
                    a.numel() * a.element_size()
                    if torch.is_tensor(a) else a.nbytes
                )
        return total


def _fe_weights(means: Mapping[str, float], imap) -> np.ndarray:
    """Dense [d] fixed-effect vector — the exact remap loop the batch
    scorer's per-dataset cache performs (model_io.LoadedGameModel.score),
    so serving weights are bitwise the batch weights."""
    w = np.zeros((imap.size,), np.float32)
    for key, v in means.items():
        i = imap.get_index(key)
        if i >= 0:
            w[i] = v
    return w


def _re_bank(
    per_entity: Mapping[str, Mapping[str, float]],
    entity_ids: Sequence[str],
    imap,
    e_pad: int,
) -> np.ndarray:
    bank = np.zeros((e_pad, imap.size), np.float32)
    for row, raw_id in enumerate(entity_ids):
        means = per_entity.get(raw_id)
        if not means:
            continue
        for key, v in means.items():
            i = imap.get_index(key)
            if i >= 0:
                bank[row, i] = v
    return bank


def _placed(arrays: Dict[str, object], device: BankDevice):
    """``(arrays, device)`` for a builder's ``device`` argument."""
    if device is False:
        return arrays, None
    dev = resolve_device(device)
    return place_on_device(arrays, dev), dev


def build_model_bank(
    loaded,
    index_maps: Mapping[str, object],
    shard_widths: Mapping[str, int],
    *,
    generation: int = 1,
    entity_pad_to: int = DEFAULT_ENTITY_PAD,
    native_index_threshold: Optional[int] = None,
    device: BankDevice = None,
    model_id: str = "",
    entity_shard: Optional[Tuple[int, int]] = None,
) -> ModelBank:
    """A `game.model_io.LoadedGameModel` -> device-resident ModelBank.

    ``entity_shard=(s, n)``: load ONE entity shard of a sharded GAME
    model — each random-effect bank keeps only the entities the shared
    ownership rule assigns to shard ``s`` (:func:`shard_entity_ids`),
    its EntityRowIndex resolves every other entity to -1, and those
    requests score FE-only exactly like unknown entities do. Matrix
    factorizations are not sharded (their two latent banks pair row AND
    column entities per request).

    ``index_maps`` must cover every shard the model references (serving
    has no dataset to infer a vocabulary from). ``shard_widths`` fixes
    the per-shard request nnz width ``k`` baked into the program shapes.

    Coordinate order is the batch scorer's (fixed effects, then random
    effects, then matrix factorizations, each in load order) so the
    per-row float adds happen in the identical sequence.

    ``device=False`` keeps host numpy arrays — the staging half of the
    hot-swap path, which places them on the serving bank's device.
    """
    spec: List[tuple] = []
    arrays: Dict[str, object] = {}
    entity_rows: Dict[str, EntityRowIndex] = {}

    def _imap(shard_id: str):
        m = index_maps.get(shard_id)
        if m is None:
            raise ValueError(
                f"serving bank needs an index map for shard {shard_id!r} "
                "(prebuilt feature maps are required on the request path)"
            )
        return m

    def _width(shard_id: str) -> int:
        k = shard_widths.get(shard_id)
        if not k or k < 1:
            raise ValueError(
                f"serving bank needs a request nnz width for shard "
                f"{shard_id!r} (got {k!r})"
            )
        return int(k)

    for name, (shard_id, means) in loaded.fixed_effects.items():
        imap = _imap(shard_id)
        w = _fe_weights(means, imap)
        spec.append(("fe", name, shard_id, imap.size, _width(shard_id)))
        arrays[name] = w

    for name, (re_type, shard_id, per_entity) in loaded.random_effects.items():
        imap = _imap(shard_id)
        ids = shard_entity_ids(sorted(per_entity), entity_shard)
        e_pad = max(_round_up(max(len(ids), 1), entity_pad_to), entity_pad_to)
        bank = _re_bank(per_entity, ids, imap, e_pad)
        if re_type in entity_rows and entity_rows[re_type].ids != ids:
            raise ValueError(
                f"random-effect coordinates disagree on the {re_type!r} "
                "entity set; per-coordinate indexes are not supported"
            )
        entity_rows.setdefault(
            re_type,
            EntityRowIndex(
                ids, native_threshold=native_index_threshold,
                shard=entity_shard,
            ),
        )
        spec.append(
            ("re", name, re_type, shard_id, e_pad, imap.size,
             _width(shard_id))
        )
        arrays[name] = bank

    for name, (row_t, col_t, rows, cols) in loaded.matrix_factorizations.items():
        K = len(next(iter(rows.values()))) if rows else 0
        banks = []
        for id_type, latent in ((row_t, rows), (col_t, cols)):
            ids = sorted(latent)
            e_pad = max(
                _round_up(max(len(ids), 1), entity_pad_to), entity_pad_to
            )
            b = np.zeros((e_pad, max(K, 1)), np.float32)
            for row, rid in enumerate(ids):
                b[row] = latent[rid]
            if id_type in entity_rows and entity_rows[id_type].ids != ids:
                raise ValueError(
                    f"coordinates disagree on the {id_type!r} entity set"
                )
            entity_rows.setdefault(
                id_type,
                EntityRowIndex(ids, native_threshold=native_index_threshold),
            )
            banks.append(b)
        spec.append(
            ("mf", name, row_t, col_t,
             banks[0].shape[0], banks[1].shape[0], max(K, 1))
        )
        arrays[name] = (banks[0], banks[1])

    arrays, dev = _placed(arrays, device)
    return ModelBank(
        generation=generation,
        spec=tuple(spec),
        arrays=arrays,
        entity_rows=entity_rows,
        index_maps=dict(index_maps),
        shard_widths={k: int(v) for k, v in shard_widths.items()},
        model_id=model_id,
        device=dev,
    )


def place_on_device(
    arrays: Dict[str, object], device: torch.device
) -> Dict[str, object]:
    """Host arrays (or tensors) -> contiguous float32 tensors on
    ``device``, each the bank's own: an in-place swap writes them, so a
    tensor never aliases the caller's array."""

    def _one(a):
        t = torch.as_tensor(a)
        out = t.to(device=device, dtype=torch.float32).contiguous()
        return out.clone() if out.data_ptr() == t.data_ptr() else out

    return {
        name: tuple(_one(a) for a in v) if isinstance(v, tuple) else _one(v)
        for name, v in arrays.items()
    }


def bank_from_arrays(
    *,
    generation: int = 1,
    fixed: Sequence[Tuple[str, str, np.ndarray]] = (),
    random: Sequence[Tuple[str, str, str, np.ndarray, Sequence[str]]] = (),
    shard_widths: Mapping[str, int],
    index_maps: Optional[Mapping[str, object]] = None,
    entity_pad_to: int = DEFAULT_ENTITY_PAD,
    native_index_threshold: Optional[int] = None,
    entity_shard: Optional[Tuple[int, int]] = None,
    device: BankDevice = None,
) -> ModelBank:
    """Assemble a bank directly from coefficient arrays — the synthetic/
    bench entry point (no Avro artifacts, same device layout).

    ``fixed``: (name, shard_id, w[d]); ``random``: (name, re_type,
    shard_id, bank[E, d], entity_ids). ``entity_shard=(s, n)`` keeps
    only shard ``s``'s rows of each random-effect bank (the ownership
    rule over each bank's given row order — callers pass sorted ids,
    matching the artifact layout).
    """
    spec: List[tuple] = []
    arrays: Dict[str, object] = {}
    entity_rows: Dict[str, EntityRowIndex] = {}
    for name, shard_id, w in fixed:
        w = np.asarray(w, np.float32)
        spec.append(
            ("fe", name, shard_id, int(w.shape[0]),
             int(shard_widths[shard_id]))
        )
        arrays[name] = w
    for name, re_type, shard_id, bank, entity_ids in random:
        bank = np.asarray(bank, np.float32)
        ids = list(entity_ids)
        if bank.shape[0] != len(ids):
            raise ValueError(
                f"bank rows {bank.shape[0]} != entity ids {len(ids)}"
            )
        if entity_shard is not None:
            s, n_sh = ownership.validate_entity_shard(entity_shard)
            keep = list(ownership.owned_positions(len(ids), s, n_sh))
            ids = shard_entity_ids(ids, entity_shard)
            bank = bank[keep]
        e_pad = max(_round_up(max(len(ids), 1), entity_pad_to), entity_pad_to)
        if e_pad == bank.shape[0]:
            padded = bank
        else:
            padded = np.zeros((e_pad, bank.shape[1]), np.float32)
            padded[: bank.shape[0]] = bank
        entity_rows.setdefault(
            re_type,
            EntityRowIndex(
                ids, native_threshold=native_index_threshold,
                shard=entity_shard,
            ),
        )
        spec.append(
            ("re", name, re_type, shard_id, e_pad, int(bank.shape[1]),
             int(shard_widths[shard_id]))
        )
        arrays[name] = padded
    arrays, dev = _placed(arrays, device)
    return ModelBank(
        generation=generation,
        spec=tuple(spec),
        arrays=arrays,
        entity_rows=entity_rows,
        index_maps=dict(index_maps or {}),
        shard_widths={k: int(v) for k, v in shard_widths.items()},
        device=dev,
    )
