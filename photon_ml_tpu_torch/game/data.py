"""GAME dataset: multi-shard sparse batches + entity codes, device-resident
(port of ``photon_ml_tpu/game/data.py``; the builders are the reference's
numpy code, so both packages make the same arrays bit for bit).

Reference: photon-ml .../data/GameDatum.scala:33-54 (response, offset,
weight, featureShardContainer, idTypeToValueMap),
avro/data/DataProcessingUtils.scala:57-143 (GenericRecord -> GameDatum:
per-shard sparse vectors from feature bags, id extraction from fields or
metadataMap), cli/game/training/Driver.scala:66-124 (prepareGameDataSet).

The shape: ONE row-aligned table. Every per-row quantity (labels,
offsets, weights, per-shard padded sparse features, per-id-type dense
entity codes) is an array over the same row axis, so scores are plain [n]
arrays (KeyValueScore.scala's fullOuterJoin algebra becomes vector adds)
and coordinate residuals stay on device.

The dataset carries the device its tensors go to (``device=`` on the
builders: the CUDA card unless the caller asks for the CPU); the row
table itself stays in numpy, and :meth:`GameDataset.batch_for_shard`
uploads each shard once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.game.config import FeatureShardConfiguration
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.utils.index_map import IndexMap, feature_key, intercept_key

Tensor = torch.Tensor


@dataclass
class EntityIndex:
    """Dense code <-> raw entity id for one random-effect type."""

    id_type: str
    ids: List[str]  # code -> raw id
    code_of: Dict[str, int]

    @property
    def num_entities(self) -> int:
        return len(self.ids)

    @staticmethod
    def build(id_type: str, values: Iterable[str]) -> "EntityIndex":
        ids = sorted(set(values))
        return EntityIndex(id_type, ids, {v: i for i, v in enumerate(ids)})


@dataclass
class ShardData:
    """Padded sparse features of one feature shard, row-aligned."""

    indices: np.ndarray  # int32 [n, k]
    values: np.ndarray  # float32 [n, k]
    index_map: IndexMap
    intercept_index: Optional[int]

    @property
    def dim(self) -> int:
        return self.index_map.size


@dataclass
class GameDataset:
    """Row-aligned GAME data table."""

    uids: List[str]
    labels: np.ndarray  # [n]
    offsets: np.ndarray  # [n]
    weights: np.ndarray  # [n]
    shards: Dict[str, ShardData]
    entity_codes: Dict[str, np.ndarray]  # id_type -> int32 [n]
    entity_indexes: Dict[str, EntityIndex]
    num_real_rows: int  # rows before padding
    # where batch_for_shard puts tensors: None is the CUDA card
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    def row_tensors(self) -> Tuple[Tensor, Tensor, Tensor]:
        """(labels, offsets, weights) on the dataset's device, uploaded once
        and shared by every shard's batch."""
        cache = self.__dict__.setdefault("_device_cache", {})
        rows = cache.get(None)
        if rows is None:
            rows = tuple(
                torch.as_tensor(a, device=self.device)
                for a in (self.labels, self.offsets, self.weights)
            )
            cache[None] = rows
        return rows

    def batch_for_shard(
        self, shard_id: str, offsets=None
    ) -> SparseBatch:
        """SparseBatch view of one shard (GameDatum.
        generateLabeledPointWithFeatureShardId analog); ``offsets``
        overrides stored offsets (the residual-score path).

        Device copies of the static columns are cached per shard: the
        coordinate-descent loop calls this every iteration and must not
        re-upload the feature table each time (device-resident
        KeyValueScore design, SURVEY §7.9) — only the offsets vector
        varies, and the residual path passes it as an already-on-device
        tensor. The batch shares the cached indices, values and weights
        tensors from call to call, which is what lets ``ensure_tiled``
        reuse its schedules across sweeps."""
        cache = self.__dict__.setdefault("_device_cache", {})
        lab, base_off, w = self.row_tensors()
        hit = cache.get(shard_id)
        if hit is None:
            sd = self.shards[shard_id]
            hit = (
                torch.as_tensor(sd.indices, device=self.device),
                torch.as_tensor(sd.values, device=self.device),
            )
            cache[shard_id] = hit
        ix, v = hit
        if offsets is not None:
            offsets = torch.as_tensor(offsets, dtype=torch.float32, device=self.device)
        return SparseBatch(
            indices=ix,
            values=v,
            labels=lab,
            offsets=base_off if offsets is None else offsets,
            weights=w,
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _padded_width(k_max: int, pad_nnz_to: int) -> int:
    """Shared nnz-padding policy for both shard builders — changing it in
    one place keeps the record-at-a-time and native-columns paths
    bit-identical (test_game_dataset_parity)."""
    return max(_round_up(max(k_max, 1), pad_nnz_to), pad_nnz_to)


def _shard_data(indices, values, imap: IndexMap, icept: int) -> ShardData:
    return ShardData(
        indices=indices,
        values=values,
        index_map=imap,
        intercept_index=icept if icept >= 0 else None,
    )


def _pad_shard_rows(
    rows: Sequence[Tuple[List[int], List[float]]],
    n_pad: int,
    pad_nnz_to: int,
    imap: IndexMap,
    icept: int,
) -> ShardData:
    """Ragged (indices, values) rows -> padded ShardData (the
    record-at-a-time builder; the native-columns builder scatters into
    its padded arrays directly but shares _padded_width/_shard_data)."""
    k_max = max([1] + [len(ix) for ix, _ in rows])
    k = _padded_width(k_max, pad_nnz_to)
    indices = np.zeros((n_pad, k), np.int32)
    values = np.zeros((n_pad, k), np.float32)
    for i, (ix, vs) in enumerate(rows):
        indices[i, : len(ix)] = ix
        values[i, : len(vs)] = vs
    return _shard_data(indices, values, imap, icept)


def _build_entity_tables(
    random_effect_types: Sequence[str],
    raw_entity: Mapping[str, List[str]],
    n_pad: int,
) -> Tuple[Dict[str, EntityIndex], Dict[str, np.ndarray]]:
    """Raw per-row entity ids -> (EntityIndex, dense code array) per type."""
    entity_indexes: Dict[str, EntityIndex] = {}
    entity_codes: Dict[str, np.ndarray] = {}
    for id_type in random_effect_types:
        raw = raw_entity[id_type]
        eidx = EntityIndex.build(id_type, raw)
        codes = np.full((n_pad,), -1, np.int32)
        for i, v in enumerate(raw):
            codes[i] = eidx.code_of[v]
        entity_indexes[id_type] = eidx
        entity_codes[id_type] = codes
    return entity_indexes, entity_codes


def record_response(r: dict, is_response_required: bool = True) -> float:
    """Response from "response" or "label" field — the single definition
    of the record-level response rule (DataProcessingUtils.scala:57-143),
    shared by the in-memory builder and the streaming GAME scan/stage
    passes (game/streaming.py)."""
    if "response" in r and r["response"] is not None:
        return float(r["response"])
    if "label" in r and r["label"] is not None:
        return float(r["label"])
    if is_response_required:
        raise ValueError("record missing response/label field")
    return 0.0


def record_entity_id(r: dict, id_type: str) -> str:
    """Entity id from a top-level field or metadataMap, stringified —
    shared with the streaming GAME passes like :func:`record_response`."""
    v = r.get(id_type)
    if v is None:
        meta = r.get("metadataMap") or {}
        v = meta.get(id_type)
    if v is None:
        raise ValueError(f"record missing id {id_type!r}")
    return str(v)


def build_game_dataset(
    records: Iterable[dict],
    shard_configs: Sequence[FeatureShardConfiguration],
    random_effect_types: Sequence[str] = (),
    *,
    index_maps: Optional[Mapping[str, IndexMap]] = None,
    is_response_required: bool = True,
    pad_rows_to: int = 8,
    pad_nnz_to: int = 8,
    row_offset: int = 0,
    device: DeviceLike = None,
) -> GameDataset:
    """Records -> GameDataset (DataProcessingUtils.getGameDataSetFrom
    GenericRecords analog).

    - response from "response" or "label" field (scoring mode tolerates
      absence with is_response_required=False);
    - ids read from top-level fields or metadataMap, stringified;
    - feature keys are name TAB term per bag, one IndexMap per shard;
    - ``row_offset`` shifts the fallback uid for records with no uid
      field so chunked builds (streaming scoring) stay globally unique;
    - ``device``: where the dataset's tensors go (the card by default).
    """
    dev = resolve_device(device)
    records = list(records)
    n = len(records)
    if n == 0:
        raise ValueError("empty GAME dataset")

    def response_of(r):
        return record_response(r, is_response_required)

    def id_of(r, id_type):
        return record_entity_id(r, id_type)

    # Build or reuse per-shard index maps.
    imaps: Dict[str, IndexMap] = {}
    for cfg in shard_configs:
        if index_maps is not None and cfg.shard_id in index_maps:
            imaps[cfg.shard_id] = index_maps[cfg.shard_id]
        else:
            keys = (
                feature_key(f["name"], f["term"])
                for r in records
                for bag in cfg.feature_bags
                for f in (r.get(bag) or [])
            )
            imaps[cfg.shard_id] = IndexMap.build(
                keys, add_intercept=cfg.add_intercept
            )

    n_pad = max(_round_up(n, pad_rows_to), pad_rows_to)
    labels = np.zeros((n_pad,), np.float32)
    offsets = np.zeros((n_pad,), np.float32)
    weights = np.zeros((n_pad,), np.float32)
    uids: List[str] = []
    for i, r in enumerate(records):
        labels[i] = response_of(r)
        off_v = r.get("offset")
        wgt_v = r.get("weight")
        offsets[i] = 0.0 if off_v is None else float(off_v)
        # None -> 1.0 but an EXPLICIT 0.0 weight stays 0 (as the native
        # column path keeps it)
        weights[i] = 1.0 if wgt_v is None else float(wgt_v)
        # row index only for a MISSING uid: 0 or "" are legitimate ids and
        # must round-trip (the native column path preserves them)
        uid_v = r.get("uid")
        uids.append(str(row_offset + i) if uid_v is None else str(uid_v))

    shards: Dict[str, ShardData] = {}
    for cfg in shard_configs:
        imap = imaps[cfg.shard_id]
        icept = imap.get_index(intercept_key()) if cfg.add_intercept else -1
        rows: List[Tuple[List[int], List[float]]] = []
        for r in records:
            ix: List[int] = []
            vs: List[float] = []
            for bag in cfg.feature_bags:
                for f in r.get(bag) or []:
                    j = imap.get_index(feature_key(f["name"], f["term"]))
                    if j >= 0:
                        ix.append(j)
                        vs.append(float(f["value"]))
            if icept >= 0:
                ix.append(icept)
                vs.append(1.0)
            rows.append((ix, vs))
        shards[cfg.shard_id] = _pad_shard_rows(
            rows, n_pad, pad_nnz_to, imap, icept
        )

    entity_indexes, entity_codes = _build_entity_tables(
        random_effect_types,
        {t: [id_of(r, t) for r in records] for t in random_effect_types},
        n_pad,
    )

    return GameDataset(
        uids=uids,
        labels=labels,
        offsets=offsets,
        weights=weights,
        shards=shards,
        entity_codes=entity_codes,
        entity_indexes=entity_indexes,
        num_real_rows=n,
        device=dev,
    )


def slice_game_dataset(ds: GameDataset, start: int, stop: int) -> GameDataset:
    """Row-range view [start, stop) over a dataset's REAL rows — the
    scoring drivers' chunk unit. Array slices are views (no copy);
    entity indexes are shared (codes are already dense)."""
    stop = min(stop, ds.num_real_rows)
    return GameDataset(
        uids=ds.uids[start:stop],
        labels=ds.labels[start:stop],
        offsets=ds.offsets[start:stop],
        weights=ds.weights[start:stop],
        shards={
            k: ShardData(
                sd.indices[start:stop], sd.values[start:stop],
                sd.index_map, sd.intercept_index,
            )
            for k, sd in ds.shards.items()
        },
        entity_codes={t: c[start:stop] for t, c in ds.entity_codes.items()},
        entity_indexes=ds.entity_indexes,
        num_real_rows=stop - start,
        device=ds.device,
    )


def build_game_dataset_from_files(
    paths,
    shard_configs: Sequence[FeatureShardConfiguration],
    random_effect_types: Sequence[str] = (),
    *,
    index_maps: Optional[Mapping[str, IndexMap]] = None,
    is_response_required: bool = True,
    pad_rows_to: int = 8,
    pad_nnz_to: int = 8,
    row_offset: int = 0,
    device: DeviceLike = None,
) -> GameDataset:
    """Avro files -> GameDataset through the native column decoder, with a
    transparent fallback to the record-at-a-time Python path
    (:func:`build_game_dataset` over ``read_avro_records``).

    The native path materializes every shard's feature bags, the
    response/offset/weight scalars, the uid, and entity ids (top-level
    string fields or metadataMap entries) as columns in one C++ pass per
    file — the JVM-executor decode of DataProcessingUtils.scala:57-143
    without Spark.
    """
    from photon_ml_tpu_torch.io.avro_codec import (
        read_avro_records,
        read_container_schema,
    )
    from photon_ml_tpu_torch.io.paths import expand_input_paths

    dev = resolve_device(device)

    def fallback():
        return build_game_dataset(
            read_avro_records(paths),
            shard_configs,
            random_effect_types,
            index_maps=index_maps,
            is_response_required=is_response_required,
            pad_rows_to=pad_rows_to,
            pad_nnz_to=pad_nnz_to,
            row_offset=row_offset,
            device=dev,
        )

    try:
        from photon_ml_tpu_torch.io import native_avro
    except Exception:
        return fallback()
    if not native_avro.available():
        return fallback()
    files = list(expand_input_paths(paths, lambda fn: fn.endswith(".avro")))
    if not files:
        return fallback()

    all_bags = sorted({b for cfg in shard_configs for b in cfg.feature_bags})
    decoded = []
    try:
        for p in files:
            schema = read_container_schema(p)
            fields = {f["name"]: f["type"] for f in schema.get("fields", [])}
            if not all(b in fields for b in all_bags):
                return fallback()
            # BOTH response and label are captured when present: the
            # Python builder falls back per RECORD (response-then-label),
            # not per file
            response_fields = [
                f for f in ("response", "label") if f in fields
            ]
            if not response_fields and is_response_required:
                return fallback()
            numeric = [
                f
                for f in response_fields + ["offset", "weight"]
                if f in fields
            ]
            top_ids = [t for t in random_effect_types if t in fields]
            map_only_ids = [t for t in random_effect_types if t not in fields]
            strings = (["uid"] if "uid" in fields else []) + top_ids
            if map_only_ids and "metadataMap" not in fields:
                return fallback()  # the Python path raises the same way
            # A NULLABLE top-level id field may be null per record with the
            # value in metadataMap — capture both and merge per record,
            # matching the Python builder's id_of fallback. Non-nullable id
            # fields skip the map capture so datasets whose metadataMap the
            # plan can't decode (non-string values) stay on the fast path.
            has_map = "metadataMap" in fields

            def _nullable(ftype):
                return isinstance(ftype, list) and any(
                    t == "null"
                    or (isinstance(t, dict) and t.get("type") == "null")
                    for t in ftype
                )

            map_keys = map_only_ids + (
                [t for t in top_ids if _nullable(fields[t])]
                if has_map
                else []
            )
            plan = native_avro.Plan(schema).compile(
                numeric_fields=numeric,
                string_fields=strings,
                bag_fields=all_bags,
                map_field="metadataMap" if map_keys else None,
                map_keys=map_keys,
            )
            cols = native_avro.decode_columns(p, plan)
            decoded.append((cols, response_fields, set(strings), set(map_keys)))
    except (native_avro.PlanError, ValueError, OSError):
        # ValueError covers decode-time native rejections; semantic errors
        # (missing ids, null labels) are re-detected identically by the
        # fallback, which raises the canonical message
        return fallback()

    n = sum(cols.num_records for cols, _, _, _ in decoded)
    if n == 0:
        raise ValueError("empty GAME dataset")
    n_pad = max(_round_up(n, pad_rows_to), pad_rows_to)
    labels = np.zeros((n_pad,), np.float32)
    offsets = np.zeros((n_pad,), np.float32)
    weights = np.zeros((n_pad,), np.float32)
    uids: List[str] = []
    raw_entity: Dict[str, List[str]] = {t: [] for t in random_effect_types}

    # scalars + ids, file by file
    row0 = 0
    for cols, response_fields, strings, map_keys in decoded:
        m = cols.num_records
        lab = np.full(m, np.nan)
        for f in response_fields:  # response first, then label, per record
            cand = cols.f64(f)
            lab = np.where(np.isnan(lab), cand, lab)
        bad = np.isnan(lab)
        if bad.any():
            if is_response_required:
                raise ValueError("record missing response/label field")
            lab = np.where(bad, 0.0, lab)
        off = (
            cols.f64("offset")
            if "offset" in cols.plan.num_slots
            else np.zeros(m)
        )
        wgt = (
            cols.f64("weight")
            if "weight" in cols.plan.num_slots
            else np.ones(m)
        )
        labels[row0:row0 + m] = lab
        offsets[row0:row0 + m] = np.where(np.isnan(off), 0.0, off)
        weights[row0:row0 + m] = np.where(np.isnan(wgt), 1.0, wgt)

        if "uid" in strings:
            for i, sid in enumerate(cols.str_ids("uid")):
                # only a MISSING uid (null branch) falls back to the row
                # index — "" is a legitimate id (as in the Python builder)
                uids.append(
                    cols.strings[sid]
                    if sid >= 0
                    else str(row_offset + row0 + i)
                )
        else:
            uids.extend(str(row_offset + row0 + i) for i in range(m))

        for t in random_effect_types:
            if t in strings:
                ids = cols.str_ids(t)
                if t in map_keys:
                    # null top-level value -> per-record metadataMap
                    # fallback (build_game_dataset's id_of)
                    ids = np.where(ids < 0, cols.map_ids(t), ids)
            else:
                ids = cols.map_ids(t)
            missing = ids < 0
            if missing.any():
                raise ValueError(f"record missing id {t!r}")
            raw_entity[t].extend(cols.strings[j] for j in ids)
        row0 += m

    # Decode every bag ONCE per file (cols.bag copies the nnz-sized
    # arrays out of the native buffers on each call) and reuse the tuples
    # for both the index-map key scan and the row assembly below.
    bag_cache: List[Dict[str, tuple]] = [
        {bag: cols.bag(bag) for bag in all_bags}
        for cols, _, _, _ in decoded
    ]

    # shards: merge each config's bags row-wise; vectorized key remap
    imaps: Dict[str, IndexMap] = {}
    for cfg in shard_configs:
        if index_maps is not None and cfg.shard_id in index_maps:
            imaps[cfg.shard_id] = index_maps[cfg.shard_id]
        else:
            keys = (
                cols.strings[j]
                for (cols, _, _, _), bags in zip(decoded, bag_cache)
                for bag in cfg.feature_bags
                for j in bags[bag][1]
            )
            imaps[cfg.shard_id] = IndexMap.build(
                keys, add_intercept=cfg.add_intercept
            )

    shards: Dict[str, ShardData] = {}
    for cfg in shard_configs:
        imap = imaps[cfg.shard_id]
        icept = imap.get_index(intercept_key()) if cfg.add_intercept else -1
        # Fully vectorized assembly (a per-record python loop here cost
        # ~30us/row): per file, remap each bag's interned keys, filter
        # dropped (-1) features, stable-sort entries by global row (bag
        # order preserved within a row), then scatter every entry into
        # the padded [n_pad, k] arrays with one flat assignment.
        per_file = []  # (row_of_entry_global, gix, values) kept entries
        counts = np.zeros(n_pad, np.int64)
        row0 = 0
        for (cols, _, _, _), bags in zip(decoded, bag_cache):
            m = cols.num_records
            # remap table restricted to intern ids this config's bags
            # actually reference (the full string table also holds uids
            # and entity ids — potentially one per row)
            cfg_keys = [bags[bag][1] for bag in cfg.feature_bags]
            used = (
                np.unique(np.concatenate(cfg_keys))
                if any(len(k) for k in cfg_keys)
                else np.zeros(0, np.int64)
            )
            table = np.full(len(cols.strings), -1, dtype=np.int64)
            for j in used:
                table[j] = imap.get_index(cols.strings[j])
            rows_parts, gix_parts, val_parts = [], [], []
            for bag in cfg.feature_bags:
                row_ptr, key_ids, values = bags[bag]
                if not len(key_ids):
                    continue
                gix = table[key_ids]
                keep = gix >= 0
                ent_rows = np.repeat(
                    np.arange(m, dtype=np.int64), np.diff(row_ptr)
                )
                rows_parts.append(ent_rows[keep])
                gix_parts.append(gix[keep])
                val_parts.append(values[keep])
            if rows_parts:
                r = np.concatenate(rows_parts)
                g = np.concatenate(gix_parts)
                v = np.concatenate(val_parts)
                # stable: equal rows keep bag-concat order, matching the
                # record-at-a-time builder's per-row bag traversal
                order = np.argsort(r, kind="stable")
                r, g, v = r[order], g[order], v[order]
            else:
                r = np.zeros(0, np.int64)
                g = np.zeros(0, np.int64)
                v = np.zeros(0, np.float32)
            counts[row0:row0 + m] = np.bincount(r, minlength=m)
            per_file.append((r + row0, g, v))
            row0 += m
        if icept >= 0:
            counts[:n] += 1  # intercept slot per real row
        k_max = int(counts.max()) if counts.size else 1
        k = _padded_width(k_max, pad_nnz_to)
        indices = np.zeros((n_pad, k), np.int32)
        values_arr = np.zeros((n_pad, k), np.float32)
        for r, g, v in per_file:
            if not len(r):
                continue
            # within-row positions: entries are row-sorted, so positions
            # are arange minus each row's start offset
            starts = np.searchsorted(r, r)  # first occurrence index per entry
            intra = np.arange(len(r)) - starts
            flat = r * k + intra
            indices.flat[flat] = g
            values_arr.flat[flat] = v
        if icept >= 0:
            rows_real = np.arange(n, dtype=np.int64)
            flat_i = rows_real * k + (counts[:n] - 1)
            indices.flat[flat_i] = icept
            values_arr.flat[flat_i] = 1.0
        shards[cfg.shard_id] = _shard_data(indices, values_arr, imap, icept)

    entity_indexes, entity_codes = _build_entity_tables(
        random_effect_types, raw_entity, n_pad
    )

    return GameDataset(
        uids=uids,
        labels=labels,
        offsets=offsets,
        weights=weights,
        shards=shards,
        entity_codes=entity_codes,
        entity_indexes=entity_indexes,
        num_real_rows=n,
        device=dev,
    )
