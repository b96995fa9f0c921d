"""Input data formats: Avro / LibSVM -> IndexMap + padded SparseBatch (port
of the in-memory part of ``photon_ml_tpu/io/input_format.py``; the
streaming protocol comes with the out-of-core path, ROADMAP item 11).

Reference: photon-ml .../io/GLMSuite.scala (Avro -> LabeledPoint with
name+TAB+term keys, intercept injection, selected-features filter, JSON
box-constraint parsing at :190-245, index map build/load at :98-187),
InputDataFormat.scala:26-51, AvroInputDataFormat.scala,
LibSVMInputDataFormat.scala:43-75, InputFormatFactory.scala.

The Spark RDD[LabeledPoint] becomes one padded SparseBatch on the device
that ``load`` is given (default: the CUDA card).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import SparseBatch, make_sparse_batch
from photon_ml_tpu_torch.io import native_avro
from photon_ml_tpu_torch.io.avro_codec import read_avro_records, read_container_schema
from photon_ml_tpu_torch.io.libsvm import parse_libsvm_line, read_libsvm
from photon_ml_tpu_torch.io.paths import expand_input_paths
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


def _intercept_index(index_map: AnyIndexMap, add_intercept: bool) -> Optional[int]:
    icept = index_map.get_index(intercept_key()) if add_intercept else -1
    return icept if icept >= 0 else None


def _to_loaded(
    row_iter, index_map: AnyIndexMap, intercept_index: Optional[int],
    constraint_string: Optional[str], device: DeviceLike,
) -> LoadedData:
    """(indices, values, label, offset, weight) rows -> LoadedData, padded
    as the reference pads (rows to 8, nnz to 8)."""
    rows, labels, offsets, weights = [], [], [], []
    for ix, vs, lab, off, wgt in row_iter:
        rows.append((ix, vs))
        labels.append(lab)
        offsets.append(off)
        weights.append(wgt)
    dim = index_map.size
    batch = make_sparse_batch(rows, labels, offsets, weights, device=device)
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

    def iter_rows_from_decoded(self, cols, index_map: AnyIndexMap, intercept_index):
        """Yield (indices, values, label, offset, weight) per record of one
        file's DecodedColumns: intern-table remap, selected-features
        filter, null/NaN rules and intercept append, as the Python-codec
        twin below."""
        table = np.asarray(
            [
                index_map.get_index(s)
                if self.selected is None or s in self.selected
                else -1
                for s in cols.strings
            ],
            dtype=np.int64,
        )
        row_ptr, key_ids, values = cols.bag("features")
        gix = table[key_ids] if len(key_ids) else np.zeros(0, np.int64)
        lab = cols.f64(self.response_field)
        if np.isnan(lab).any():
            # the Python codec would fail on float(None); a NaN label must
            # not silently poison the fit
            raise ValueError("null/NaN label in Avro input (native decode)")
        off = cols.f64("offset") if "offset" in cols.plan.num_slots else np.zeros(len(lab))
        wgt = cols.f64("weight") if "weight" in cols.plan.num_slots else np.ones(len(lab))
        # only the null sentinel is replaced; inf passes through, as in
        # the Python codec
        off = np.where(np.isnan(off), 0.0, off)
        wgt = np.where(np.isnan(wgt), 1.0, wgt)
        for i in range(cols.num_records):
            lo, hi = int(row_ptr[i]), int(row_ptr[i + 1])
            g = gix[lo:hi]
            keep = g >= 0
            ix = g[keep].tolist()
            vs = values[lo:hi][keep].tolist()
            if intercept_index is not None:
                ix.append(intercept_index)
                vs.append(1.0)
            yield ix, vs, float(lab[i]), float(off[i]), float(wgt[i])

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
            row_iter = (
                row
                for cols in decoded
                for row in self.iter_rows_from_decoded(cols, index_map, intercept_index)
            )
        else:
            row_iter = self.iter_rows_from_records(
                read_avro_records(paths), index_map, intercept_index
            )
        return _to_loaded(row_iter, index_map, intercept_index, constraint_string, device)


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
        row_iter = (
            row for path in self.files(paths) for row in self.file_rows(path, index_map)
        )
        return _to_loaded(row_iter, index_map, intercept_index, constraint_string, device)

    def files(self, paths) -> List[str]:
        files = sorted(expand_input_paths(paths))
        if not files:
            raise ValueError(f"no inputs under {paths!r}")
        return files

    def file_rows(self, path: str, index_map: AnyIndexMap):
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


def create_input_format(kind: str, **kwargs):
    """InputFormatFactory analog: kind in {AVRO, LIBSVM}."""
    k = kind.strip().upper()
    if k == "AVRO":
        return AvroInputDataFormat(**kwargs)
    if k == "LIBSVM":
        return LibSVMInputDataFormat(**kwargs)
    raise ValueError(f"unknown input format: {kind}")
