"""Input data formats: Avro / LibSVM -> IndexMap + padded SparseBatch, and
the streaming protocol that ``io/streaming.py`` drives (port of
``photon_ml_tpu/io/input_format.py``).

Reference: photon-ml .../io/GLMSuite.scala (Avro -> LabeledPoint with
name+TAB+term keys, intercept injection, selected-features filter, JSON
box-constraint parsing at :190-245, index map build/load at :98-187),
InputDataFormat.scala:26-51, AvroInputDataFormat.scala,
LibSVMInputDataFormat.scala:43-75, InputFormatFactory.scala.

The Spark RDD[LabeledPoint] becomes one padded SparseBatch on the device
that ``load`` is given (default: the CUDA card).
"""

from __future__ import annotations

import itertools
import json
import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import SparseBatch, _round_up, sparse_batch_from_arrays
from photon_ml_tpu_torch.io import native_avro
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary, finalize_summary
from photon_ml_tpu_torch.io.avro_codec import read_avro_records, read_container_schema
from photon_ml_tpu_torch.io.libsvm import parse_libsvm_line, read_libsvm
from photon_ml_tpu_torch.io.paths import expand_input_paths
from photon_ml_tpu_torch.io.streaming import RowBlock, StreamStats, rows_to_block
from photon_ml_tpu_torch.optim.common import BoxConstraints
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.utils.index_map import (
    IdentityIndexMap,
    IndexMap,
    feature_key,
    intercept_key,
)

AnyIndexMap = Union[IndexMap, IdentityIndexMap]


@dataclass
class LoadedData:
    """One loaded dataset: batch + vocabulary + optional constraints."""

    batch: SparseBatch
    index_map: AnyIndexMap
    num_features: int
    intercept_index: Optional[int]
    constraints: Optional[BoxConstraints] = None


def parse_constraint_string(
    constraint_string: Optional[str],
    index_map: AnyIndexMap,
    num_features: int,
    intercept_index: Optional[int],
    *,
    device: DeviceLike = None,
) -> Optional[BoxConstraints]:
    """JSON array of {name, term, lowerBound, upperBound} -> box tensors on
    ``device``.

    Wildcard "*" in name (with any term) applies the bound to every
    non-intercept feature; overlapping constraints are rejected
    (GLMSuite.createConstraintFeatureMap:190-245).
    """
    if not constraint_string:
        return None
    entries = json.loads(constraint_string)
    lower = np.full((num_features,), -np.inf, np.float32)
    upper = np.full((num_features,), np.inf, np.float32)
    seen: Dict[int, Tuple[float, float]] = {}
    wildcard: Optional[Tuple[float, float]] = None
    for entry in entries:
        if "name" not in entry or "term" not in entry:
            raise ValueError(f"constraint entry must contain name and term: {entry}")
        name = entry["name"]
        term = entry["term"]
        lo = float(entry.get("lowerBound", -math.inf))
        hi = float(entry.get("upperBound", math.inf))
        if lo > hi:
            raise ValueError(f"lowerBound > upperBound in constraint {entry}")
        if name == "*":
            if wildcard is not None or seen:
                raise ValueError("conflicting constraints: wildcard plus other constraints")
            wildcard = (lo, hi)
        else:
            if wildcard is not None:
                raise ValueError("conflicting constraints: wildcard plus other constraints")
            idx = index_map.get_index(feature_key(name, term))
            if idx < 0:
                continue  # constraint on a feature absent from the data
            if idx in seen and seen[idx] != (lo, hi):
                raise ValueError(f"conflicting constraints for feature ({name},{term})")
            seen[idx] = (lo, hi)
            lower[idx], upper[idx] = lo, hi
    if wildcard is not None:
        lower[:], upper[:] = wildcard
        if intercept_index is not None:
            lower[intercept_index], upper[intercept_index] = -np.inf, np.inf
    elif not seen:
        return None
    dev = resolve_device(device)
    return BoxConstraints(
        lower=torch.as_tensor(lower, device=dev), upper=torch.as_tensor(upper, device=dev)
    )


def _lookup(index_map: AnyIndexMap, keys: Sequence[str]) -> np.ndarray:
    """int64 indices of ``keys`` (-1 where absent): the map's vectorized
    lookup where it has one."""
    many = getattr(index_map, "get_indices", None)
    if many is not None:
        return np.asarray(many(list(keys)), np.int64)
    return np.asarray([index_map.get_index(k) for k in keys], np.int64).reshape(-1)


def _intercept_index(index_map: AnyIndexMap, add_intercept: bool) -> Optional[int]:
    icept = index_map.get_index(intercept_key()) if add_intercept else -1
    return icept if icept >= 0 else None


def _batch_from_blocks(blocks: Sequence[RowBlock], device: DeviceLike) -> SparseBatch:
    """RowBlocks -> one SparseBatch padded as ``make_sparse_batch`` pads
    rows (rows and nnz rounded up to 8; float32 values and row arrays)."""
    n = sum(len(b.lens) for b in blocks)
    if n == 0:
        raise ValueError("empty batch")
    k = max(max((int(b.lens.max()) for b in blocks if len(b.lens)), default=1), 1)
    k = max(_round_up(k, 8), 8)
    n_pad = max(_round_up(n, 8), 8)
    indices = np.zeros((n_pad, k), np.int32)
    values = np.zeros((n_pad, k), np.float32)
    rows = np.zeros((3, n_pad), np.float32)  # labels, offsets, weights
    a = 0
    for b in blocks:
        m, w = len(b.lens), min(b.ix.shape[1], k)
        indices[a:a + m, :w] = b.ix[:, :w]
        values[a:a + m, :w] = b.v[:, :w]
        rows[:, a:a + m] = (b.lab, b.off, b.wgt)
        a += m
    return sparse_batch_from_arrays(indices, values, *rows, device=device)


def _to_loaded(
    blocks, index_map: AnyIndexMap, intercept_index: Optional[int],
    constraint_string: Optional[str], device: DeviceLike,
) -> LoadedData:
    """RowBlocks -> LoadedData, padded as the reference pads (rows to 8,
    nnz to 8)."""
    dim = index_map.size
    batch = _batch_from_blocks(list(blocks), device)
    constraints = parse_constraint_string(
        constraint_string, index_map, dim, intercept_index, device=device
    )
    return LoadedData(batch, index_map, dim, intercept_index, constraints)


class AvroInputDataFormat:
    """TrainingExampleAvro reader (GLMSuite Avro path).

    ``selected_features``: optional set of feature keys to keep
    (GLMSuite.featureKeySet filtering); ``add_intercept`` appends the
    constant-1 intercept feature to every row (GLMSuite.addIntercept).
    ``field_names``: the Avro field-name convention
    (io/FieldNamesType.scala): TRAINING_EXAMPLE reads the response from
    ``label``, RESPONSE_PREDICTION from ``response``.
    """

    def __init__(
        self,
        *,
        add_intercept: bool = True,
        selected_features: Optional[Sequence[str]] = None,
        field_names: str = "TRAINING_EXAMPLE",
    ):
        self.add_intercept = add_intercept
        self.selected = set(selected_features) if selected_features else None
        fn = field_names.strip().upper()
        if fn in ("TRAINING_EXAMPLE", "NONE"):
            self.response_field = "label"
        elif fn == "RESPONSE_PREDICTION":
            self.response_field = "response"
        else:
            raise ValueError(f"unknown field names type {field_names!r}")

    def _record_pairs(self, record: dict) -> Iterable[Tuple[str, float]]:
        for f in record["features"]:
            key = feature_key(f["name"], f["term"])
            if self.selected is None or key in self.selected:
                yield key, float(f["value"])

    def decode_file(self, path: str):
        """Native column decode of ONE file; None -> the caller uses the
        Python codec (the decoder is unavailable or the schema's shape is
        one it does not handle)."""
        if not native_avro.available():
            return None
        try:
            schema = read_container_schema(path)
            names = {f["name"] for f in schema.get("fields", [])}
            if "features" not in names or self.response_field not in names:
                return None
            numeric = [f for f in (self.response_field, "offset", "weight") if f in names]
            plan = native_avro.Plan(schema).compile(
                numeric_fields=numeric, bag_fields=["features"]
            )
            return native_avro.decode_columns(path, plan)
        except (native_avro.PlanError, ValueError, OSError):
            return None

    def _decode_native(self, paths):
        """The native column decode of EVERY file, or None (then every file
        goes through the Python codec, so one load never mixes decode
        semantics)."""
        files = list(expand_input_paths(paths, lambda fn: fn.endswith(".avro")))
        if not files:
            return None
        out = []
        for p in files:
            cols = self.decode_file(p)
            if cols is None:
                return None
            out.append(cols)
        return out

    def decoded_row_block(self, cols, index_map: AnyIndexMap, intercept_index) -> RowBlock:
        """One file's DecodedColumns as a padded RowBlock: intern-table
        remap, selected-features filter, null/NaN rules and intercept
        append, as the Python-codec twin ``iter_rows_from_records`` gives
        them row by row (the values stay float64)."""
        table = _lookup(index_map, cols.strings)
        if self.selected is not None:
            table[~self._selected_mask(cols)] = -1
        row_ptr, key_ids, values = cols.bag("features")
        gix = table[key_ids] if len(key_ids) else np.zeros(0, np.int64)
        lab = cols.f64(self.response_field)
        if np.isnan(lab).any():
            # the Python codec would fail on float(None); a NaN label must
            # not silently poison the fit
            raise ValueError("null/NaN label in Avro input (native decode)")
        m = cols.num_records
        off = cols.f64("offset") if "offset" in cols.plan.num_slots else np.zeros(m)
        wgt = cols.f64("weight") if "weight" in cols.plan.num_slots else np.ones(m)
        # only the null sentinel is replaced; inf passes through, as in
        # the Python codec
        off = np.where(np.isnan(off), 0.0, off)
        wgt = np.where(np.isnan(wgt), 1.0, wgt)
        keep = gix >= 0
        kept_before = np.concatenate([[0], np.cumsum(keep)])
        starts = np.asarray(row_ptr[:-1], np.int64)
        counts = kept_before[np.asarray(row_ptr[1:], np.int64)] - kept_before[starts]
        row_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))[keep]
        # each kept entry's slot: its rank among its row's kept entries
        pos = kept_before[:-1][keep] - kept_before[starts][row_of]
        extra = 1 if intercept_index is not None else 0
        width = int(counts.max()) + extra if m else extra
        ix = np.zeros((m, max(width, 1)), np.int64)
        v = np.zeros((m, max(width, 1)), np.float64)
        ix[row_of, pos] = gix[keep]
        v[row_of, pos] = values[keep]
        if intercept_index is not None:
            ix[np.arange(m), counts] = intercept_index
            v[np.arange(m), counts] = 1.0
        return RowBlock(ix, v, counts + extra, lab, off, wgt)

    def iter_rows_from_decoded(self, cols, index_map: AnyIndexMap, intercept_index):
        """Yield (indices, values, label, offset, weight) per record of one
        file's DecodedColumns (:meth:`decoded_row_block`, row by row)."""
        block = self.decoded_row_block(cols, index_map, intercept_index)
        for i, n in enumerate(block.lens.tolist()):
            yield (
                block.ix[i, :n].tolist(), block.v[i, :n].tolist(),
                float(block.lab[i]), float(block.off[i]), float(block.wgt[i]),
            )

    def iter_rows_from_records(self, records, index_map: AnyIndexMap, intercept_index):
        """Python-codec twin of iter_rows_from_decoded."""
        for record in records:
            ix: List[int] = []
            vs: List[float] = []
            for key, value in self._record_pairs(record):
                i = index_map.get_index(key)
                if i >= 0:
                    ix.append(i)
                    vs.append(value)
            if intercept_index is not None:
                ix.append(intercept_index)
                vs.append(1.0)
            off_v = record.get("offset")
            wgt_v = record.get("weight")
            yield (
                ix, vs, float(record[self.response_field]),
                0.0 if off_v is None else float(off_v),
                1.0 if wgt_v is None else float(wgt_v),
            )

    # -- streaming protocol (io/streaming.py drives these) -----------------

    def _stream_intercept(self, index_map: AnyIndexMap) -> Optional[int]:
        return _intercept_index(index_map, self.add_intercept)

    def stream_files(self, paths) -> List[str]:
        """Sorted input files of the bounded-memory streaming path."""
        files = sorted(expand_input_paths(paths, lambda fn: fn.endswith(".avro")))
        if not files:
            raise ValueError(f"no .avro inputs under {paths!r}")
        return files

    def stream_rows(self, path: str, index_map: AnyIndexMap):
        """(indices, values, label, offset, weight) per record of ONE file,
        one decoded file resident at a time; the remap semantics are
        ``iter_rows_from_{decoded,records}``, shared with :meth:`load`."""
        yield from self.stream_rows_from_payload(self.decode_payload(path), path, index_map)

    # The two stages of stream_rows, split so that the streaming layer can
    # decode file i + 1 on a worker thread while it stages file i
    # (io/streaming._pipelined_file_rows).

    def decode_payload(self, path: str):
        """Decode stage: ONE file's decoded columns (None -> the Python
        codec in :meth:`stream_rows_from_payload`). Thread-safe."""
        return self.decode_file(path)

    def stream_block_from_payload(self, payload, path: str, index_map: AnyIndexMap) -> RowBlock:
        """Staging stage, whole file: its rows as one RowBlock (the native
        decode's vectorized remap; the Python codec's rows packed)."""
        icept = self._stream_intercept(index_map)
        if payload is not None:
            return self.decoded_row_block(payload, index_map, icept)
        return rows_to_block(
            self.iter_rows_from_records(read_avro_records([path]), index_map, icept)
        )

    def stream_rows_from_payload(self, payload, path: str, index_map: AnyIndexMap):
        """Staging stage: the rows of one file from its decoded payload."""
        icept = self._stream_intercept(index_map)
        if payload is not None:
            yield from self.iter_rows_from_decoded(payload, index_map, icept)
        else:
            yield from self.iter_rows_from_records(read_avro_records([path]), index_map, icept)

    def _selected_mask(self, decoded) -> np.ndarray:
        return np.asarray(
            [self.selected is None or s in self.selected for s in decoded.strings],
            dtype=bool,
        )

    @staticmethod
    def _live_widths(decoded, sel: np.ndarray) -> Tuple[np.ndarray, int]:
        """(row widths, max live entries of a row): an entry is live when
        its key is selected (zero values count; the row iterators emit
        them)."""
        row_ptr, key_ids, _ = decoded.bag("features")
        widths = np.diff(row_ptr)
        if not decoded.num_records:
            return widths, 0
        live = sel[key_ids] if len(key_ids) else np.zeros(0, bool)
        counts = np.add.reduceat(
            np.concatenate([live.astype(np.int64), [0]]), row_ptr[:-1]
        )
        # reduceat returns the element at the index for an empty row
        counts = np.where(widths > 0, counts, 0)
        return widths, int(counts.max()) if len(counts) else 0

    def scan_file(self, path: str, keys: Optional[set] = None) -> Tuple[int, int]:
        """One file's (rows, max live entries of a row), adding its selected
        feature keys to ``keys`` when given: the unit of :meth:`stream_scan`
        and of the per-partition scan cache."""
        decoded = self.decode_file(path)
        if decoded is not None:
            sel = self._selected_mask(decoded)
            if keys is not None:
                keys.update(itertools.compress(decoded.strings, sel))
            return decoded.num_records, self._live_widths(decoded, sel)[1]
        num_rows = max_live = 0
        for record in read_avro_records([path]):
            live = 0
            for key, _v in self._record_pairs(record):
                if keys is not None:
                    keys.add(key)
                live += 1
            max_live = max(max_live, live)
            num_rows += 1
        return num_rows, max_live

    def stream_scan(self, paths, index_map: Optional[AnyIndexMap] = None):
        """One pass over the files, ONE AT A TIME: the vocabulary, the row
        count and the max per-row nnz (with the intercept) that fix the
        staging batch. With a prebuilt ``index_map`` only the shape stats
        are scanned. -> (index_map, StreamStats)."""
        keys = set() if index_map is None else None
        num_rows = max_live = 0
        for path in self.stream_files(paths):
            rows, live = self.scan_file(path, keys)
            num_rows += rows
            max_live = max(max_live, live)
        if keys is not None:
            index_map = IndexMap.build(iter(keys), add_intercept=self.add_intercept)
        max_nnz = max(max_live + (1 if self.add_intercept else 0), 1)
        return index_map, StreamStats(num_rows=num_rows, max_nnz=max_nnz)

    def stream_scan_with_summary(
        self, paths, index_map: Optional[AnyIndexMap] = None, *, device: DeviceLike = None,
    ):
        """ONE pass collecting the vocabulary, the staging-shape stats AND
        the colStats summary: the fused form of ``stream_scan`` +
        ``io.streaming.streaming_summary``. Moments accumulate in float64
        per feature KEY (the vocabulary is fixed only at the end), in file
        order, and scatter into index order once the map exists; the
        summary is finalized in float32 on ``device``. Memory: one decoded
        file + O(vocabulary) moments. -> (index_map, StreamStats,
        BasicStatisticalSummary)."""
        files = self.stream_files(paths)
        collect_keys = index_map is None
        moments = _KeyMoments()

        def slot(key: str) -> int:
            s = moments.slot_of.get(key, -1)
            if s < 0:
                if not collect_keys and index_map.get_index(key) < 0:
                    return -1  # the prebuilt map drops this feature
                s = moments.add(key)
            return s

        num_rows = 0
        real_rows = 0.0
        max_live = 0
        for path in files:
            decoded = self.decode_file(path)
            if decoded is not None:
                m = decoded.num_records
                sel = self._selected_mask(decoded)
                slot_table = np.asarray(
                    [slot(s) if ok else -1 for s, ok in zip(decoded.strings, sel)],
                    np.int64,
                )
                wgt = decoded.f64("weight") if "weight" in decoded.plan.num_slots else np.ones(m)
                real = np.where(np.isnan(wgt), 1.0, wgt) > 0
                real_rows += float(real.sum())
                widths, live = self._live_widths(decoded, sel)
                max_live = max(max_live, live)
                num_rows += m
                _, key_ids, values = decoded.bag("features")
                if len(key_ids):
                    row_of = np.repeat(np.arange(m, dtype=np.int64), widths)
                    ks = slot_table[key_ids]
                    # value-0 entries are moment no-ops: dropped
                    keep = (ks >= 0) & real[row_of] & (values != 0)
                    moments.add_entries(ks[keep], values[keep].astype(np.float64))
            else:
                for record in read_avro_records([path]):
                    wgt_v = record.get("weight")
                    real = (1.0 if wgt_v is None else float(wgt_v)) > 0
                    real_rows += 1.0 if real else 0.0
                    live = 0
                    for key, value in self._record_pairs(record):
                        live += 1
                        s = slot(key)
                        if s >= 0 and real and value != 0:
                            moments.add_one(s, value)
                    max_live = max(max_live, live)
                    num_rows += 1
        if collect_keys:
            index_map = IndexMap.build(iter(moments.slot_of), add_intercept=self.add_intercept)
        summary = moments.summary(
            index_map, self._stream_intercept(index_map), real_rows, device=device
        )
        max_nnz = max(max_live + (1 if self.add_intercept else 0), 1)
        return index_map, StreamStats(num_rows=num_rows, max_nnz=max_nnz), summary

    def _index_map_from_decoded(self, decoded) -> IndexMap:
        keys = (
            key
            for cols in decoded
            for key in cols.strings
            if self.selected is None or key in self.selected
        )
        return IndexMap.build(keys, add_intercept=self.add_intercept)

    def build_index_map(self, paths) -> IndexMap:
        decoded = self._decode_native(paths)
        if decoded is not None:
            return self._index_map_from_decoded(decoded)
        keys = (
            key
            for record in read_avro_records(paths)
            for key, _ in self._record_pairs(record)
        )
        return IndexMap.build(keys, add_intercept=self.add_intercept)

    def load(
        self,
        paths,
        index_map: Optional[AnyIndexMap] = None,
        constraint_string: Optional[str] = None,
        *,
        device: DeviceLike = None,
    ) -> LoadedData:
        decoded = self._decode_native(paths)
        if index_map is None:
            index_map = (
                self._index_map_from_decoded(decoded)
                if decoded is not None
                else self.build_index_map(paths)
            )
        intercept_index = _intercept_index(index_map, self.add_intercept)
        if decoded is not None:
            blocks = [
                self.decoded_row_block(cols, index_map, intercept_index) for cols in decoded
            ]
        else:
            blocks = [rows_to_block(self.iter_rows_from_records(
                read_avro_records(paths), index_map, intercept_index
            ))]
        return _to_loaded(blocks, index_map, intercept_index, constraint_string, device)


class LibSVMInputDataFormat:
    """LibSVM text reader (LibSVMInputDataFormat.scala analog).

    ``selected_features``: optional feature-key filter, matching the Avro
    format's semantics (keys are ``str(index) + TAB``).
    ``feature_dimension``: pre-declared dimension (``--feature-dimension``):
    indices are the ids, with no vocabulary scan.
    """

    def __init__(
        self,
        *,
        add_intercept: bool = True,
        zero_based: bool = False,
        selected_features: Optional[Sequence[str]] = None,
        feature_dimension: Optional[int] = None,
    ):
        self.add_intercept = add_intercept
        self.zero_based = zero_based
        self.selected = set(selected_features) if selected_features else None
        self.feature_dimension = feature_dimension

    def build_index_map(self, paths) -> AnyIndexMap:
        if self.feature_dimension is not None:
            # LibSVMInputDataFormat.scala:32-39: the intercept, when
            # enabled, is appended after the declared features
            return IdentityIndexMap(self.feature_dimension, add_intercept=self.add_intercept)
        keys = (
            key
            for _, pairs in read_libsvm(paths, zero_based=self.zero_based)
            for key in (feature_key(str(idx)) for idx, _ in pairs)
            if self.selected is None or key in self.selected
        )
        return IndexMap.build(keys, add_intercept=self.add_intercept)

    def load(
        self,
        paths,
        index_map: Optional[AnyIndexMap] = None,
        constraint_string: Optional[str] = None,
        *,
        device: DeviceLike = None,
    ) -> LoadedData:
        if index_map is None:
            index_map = self.build_index_map(paths)
        intercept_index = _intercept_index(index_map, self.add_intercept)
        # ONE remap definition: the in-memory loader iterates the rows the
        # streaming path stages
        rows = (
            row for path in self.stream_files(paths) for row in self.stream_rows(path, index_map)
        )
        return _to_loaded(
            [rows_to_block(rows)], index_map, intercept_index, constraint_string, device
        )

    # -- streaming protocol (io/streaming.py drives these): one line
    # resident at a time

    def stream_files(self, paths) -> List[str]:
        files = sorted(expand_input_paths(paths))
        if not files:
            raise ValueError(f"no inputs under {paths!r}")
        return files

    def stream_rows(self, path: str, index_map: AnyIndexMap):
        """(indices, values, label, offset, weight) per line of ONE file:
        the selected-features filter, the index map's range check and the
        intercept append."""
        icept = _intercept_index(index_map, self.add_intercept)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parsed = parse_libsvm_line(line, zero_based=self.zero_based)
                if parsed is None:
                    continue
                label, pairs = parsed
                ix: List[int] = []
                vs: List[float] = []
                for idx, value in pairs:
                    key = feature_key(str(idx))
                    if self.selected is not None and key not in self.selected:
                        continue
                    i = index_map.get_index(key)
                    if i >= 0:
                        ix.append(i)
                        vs.append(value)
                if icept is not None:
                    ix.append(icept)
                    vs.append(1.0)
                yield ix, vs, label, 0.0, 1.0

    def stream_scan(self, paths, index_map: Optional[AnyIndexMap] = None):
        """Line-at-a-time vocabulary + staging-shape scan. A pre-declared
        ``feature_dimension`` skips the vocabulary (identity map), as
        :meth:`build_index_map` does. -> (index_map, StreamStats)."""
        files = self.stream_files(paths)
        collect_keys = index_map is None
        keys = set()
        num_rows = 0
        max_live = 0
        for path in files:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    parsed = parse_libsvm_line(line, zero_based=self.zero_based)
                    if parsed is None:
                        continue
                    live = 0
                    for idx, _v in parsed[1]:
                        key = feature_key(str(idx))
                        if self.selected is not None and key not in self.selected:
                            continue
                        if collect_keys and self.feature_dimension is None:
                            keys.add(key)
                        live += 1
                    max_live = max(max_live, live)
                    num_rows += 1
        if collect_keys:
            if self.feature_dimension is not None:
                index_map = IdentityIndexMap(
                    self.feature_dimension, add_intercept=self.add_intercept
                )
            else:
                index_map = IndexMap.build(iter(keys), add_intercept=self.add_intercept)
        max_nnz = max(max_live + (1 if self.add_intercept else 0), 1)
        return index_map, StreamStats(num_rows=num_rows, max_nnz=max_nnz)


class _KeyMoments:
    """Per-key float64 moment partials (s1, s2, l1, nnz, max, min) in a
    growing table, for the fused scan: keys get slots in first-seen
    order, and entries add in the order they come."""

    def __init__(self, cap: int = 1024):
        self.slot_of: Dict[str, int] = {}
        self.cols = self._empty(cap)

    @staticmethod
    def _empty(n: int) -> List[np.ndarray]:
        return [np.zeros(n) for _ in range(4)] + [np.full(n, -np.inf), np.full(n, np.inf)]

    def add(self, key: str) -> int:
        s = len(self.slot_of)
        self.slot_of[key] = s
        cap = len(self.cols[0])
        if s >= cap:
            grown = self._empty(cap)
            self.cols = [np.concatenate([c, g]) for c, g in zip(self.cols, grown)]
        return s

    def add_entries(self, slots: np.ndarray, v: np.ndarray) -> None:
        s1, s2, l1, nnz, mx, mn = self.cols
        np.add.at(s1, slots, v)
        np.add.at(s2, slots, v * v)
        np.add.at(l1, slots, np.abs(v))
        np.add.at(nnz, slots, 1.0)
        np.maximum.at(mx, slots, v)
        np.minimum.at(mn, slots, v)

    def add_one(self, s: int, value: float) -> None:
        s1, s2, l1, nnz, mx, mn = self.cols
        s1[s] += value
        s2[s] += value * value
        l1[s] += abs(value)
        nnz[s] += 1.0
        mx[s] = max(mx[s], value)
        mn[s] = min(mn[s], value)

    def summary(
        self, index_map: AnyIndexMap, icept: Optional[int], real_rows: float, *,
        device: DeviceLike = None,
    ) -> BasicStatisticalSummary:
        """Scatter the partials into index order and finalize in float32."""
        dim = index_map.size
        out = self._empty(dim)
        for key, s in self.slot_of.items():
            j = index_map.get_index(key)
            if j >= 0:
                for o, c in zip(out, self.cols):
                    o[j] = c[s]
        return summary_from_moments(out, icept, real_rows, device=device)


def summary_from_moments(
    moments: Sequence[np.ndarray], icept: Optional[int], real_rows: float, *,
    device: DeviceLike = None,
) -> BasicStatisticalSummary:
    """Float64 (s1, s2, l1, nnz, max, min) in index order -> the summary,
    finalized in float32 on ``device``. Every real row carries the
    constant-1 intercept entry, so its moments are set from the count."""
    s1, s2, l1, nnz, mx, mn = (np.array(m, np.float64) for m in moments)
    if icept is not None and real_rows > 0:
        s1[icept] = s2[icept] = l1[icept] = nnz[icept] = real_rows
        mx[icept] = mn[icept] = 1.0
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return finalize_summary(f32(real_rows), f32(s1), f32(s2), f32(l1), f32(nnz), f32(mx), f32(mn))


def create_input_format(kind: str, **kwargs):
    """InputFormatFactory analog: kind in {AVRO, LIBSVM}."""
    k = kind.strip().upper()
    if k == "AVRO":
        return AvroInputDataFormat(**kwargs)
    if k == "LIBSVM":
        return LibSVMInputDataFormat(**kwargs)
    raise ValueError(f"unknown input format: {kind}")
