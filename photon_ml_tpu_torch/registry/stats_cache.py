"""Append-only per-partition scan/stats cache (port of
``photon_ml_tpu/registry/stats_cache.py``): a retrain over appended data
scans only the partitions it has not seen.

One entry per partition file, keyed by a spot digest of the file's bytes
(size + first and last 64 KiB), holds exactly the partition's reductions:
row count, max live nnz, key set and (for the fused summary) float64
moment partials per key. The entry layout and ``STATS_CACHE_VERSION`` are
the JAX package's, so a cache written by either package is read by the
other. The ``scanned`` / ``cached`` counters make "only new partitions" a
counted claim.

Exactness: the index map and StreamStats of a cached scan are exactly the
uncached ones (key sets union, ``IndexMap.build`` sorts, rows add, max
nnz maxes). The summary merges float64 partials in sorted-file order, so
its moments may differ from the fused single pass's by float64 rounding.

An entry that fails to decode, or an injected CORRUPT at the
``registry.stats_cache`` seam, is quarantined to ``*.corrupt`` (counted)
and its partition rescanned.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from hashlib import blake2b
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.io.avro_codec import read_avro_records
from photon_ml_tpu_torch.io.input_format import summary_from_moments
from photon_ml_tpu_torch.io.streaming import StreamStats
from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json
from photon_ml_tpu_torch.reliability.faults import InjectedCorruption
from photon_ml_tpu_torch.reliability.retry import SeamFailure, io_call, quarantine_artifact
from photon_ml_tpu_torch.utils.device import DeviceLike
from photon_ml_tpu_torch.utils.index_map import IndexMap, intercept_key

STATS_CACHE_SEAM = "registry.stats_cache"

# Bump when the entry layout or the reductions' semantics change: keys of
# another version miss and rescan.
STATS_CACHE_VERSION = 1

_SPOT_BYTES = 64 * 1024


def _partition_key(path: str) -> str:
    """Content key of one partition file: size + first/last 64 KiB. A
    rewritten file (size or edge bytes changed) misses and rescans."""
    st = os.stat(path)
    h = blake2b(digest_size=16)
    h.update(str(STATS_CACHE_VERSION).encode())
    h.update(b"\0")
    h.update(str(st.st_size).encode())
    h.update(b"\0")
    with open(path, "rb") as f:
        h.update(f.read(_SPOT_BYTES))
        if st.st_size > _SPOT_BYTES:
            f.seek(max(st.st_size - _SPOT_BYTES, 0))
            h.update(f.read(_SPOT_BYTES))
    return h.hexdigest()


@dataclass
class ScanCacheStats:
    """Per-call accounting: the "only new partitions" counters."""

    partitions: int = 0
    scanned: int = 0  # partitions read again
    cached: int = 0  # partitions served from the cache
    stored: int = 0
    quarantined: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class _PartitionEntry:
    rows: int
    max_live: int
    keys: List[str]
    # per-key float64 partials (s1, s2, l1, nnz, max, min) and the
    # partition's positive-weight rows, for the fused summary;
    # has_moments tells "not collected" (a scan-only entry) from "zero"
    has_moments: bool = False
    real_rows: float = 0.0
    moments: Dict[str, Tuple[float, float, float, float, float, float]] = field(
        default_factory=dict
    )


class PartitionStatsCache:
    """One directory of ``v<version>/<key>.json`` entries (append-only)."""

    def __init__(self, cache_dir: str):
        self.cache_dir = os.path.abspath(cache_dir)
        self.stats = ScanCacheStats()

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"v{STATS_CACHE_VERSION}", f"{key}.json")

    def load(self, path: str, key: str) -> Optional[_PartitionEntry]:
        entry_path = self._entry_path(key)
        if not os.path.isfile(entry_path):
            return None

        def _load():
            with open(entry_path) as f:
                data = json.load(f)
            if data.get("version") != STATS_CACHE_VERSION or data.get("key") != key:
                raise ValueError(f"stats-cache entry {entry_path} version/key mismatch")
            return _PartitionEntry(
                rows=int(data["rows"]),
                max_live=int(data["max_live"]),
                keys=list(data["keys"]),
                has_moments=bool(data.get("has_moments", False)),
                real_rows=float(data.get("real_rows", 0.0)),
                moments={k: tuple(v) for k, v in data.get("moments", {}).items()},
            )

        try:
            return io_call(STATS_CACHE_SEAM, _load, detail=entry_path)
        except (InjectedCorruption, ValueError, KeyError, TypeError):
            # a poisoned entry costs one rescan, never a wrong model
            quarantine_artifact(entry_path, STATS_CACHE_SEAM)
            self.stats.quarantined += 1
            return None
        except SeamFailure:
            return None  # the cache is an accelerator: rescan

    def store(self, path: str, key: str, entry: _PartitionEntry) -> None:
        entry_path = self._entry_path(key)
        payload = {
            "version": STATS_CACHE_VERSION,
            "key": key,
            "source": os.path.basename(path),
            "rows": entry.rows,
            "max_live": entry.max_live,
            "keys": entry.keys,
            "has_moments": entry.has_moments,
            "real_rows": entry.real_rows,
            "moments": {k: list(v) for k, v in entry.moments.items()},
        }

        def _store():
            os.makedirs(os.path.dirname(entry_path), exist_ok=True)
            # compact: an entry holds a partition's whole key set
            atomic_write_json(entry_path, payload, indent=None)

        try:
            io_call(STATS_CACHE_SEAM, _store, detail=entry_path)
            self.stats.stored += 1
        except SeamFailure:
            return  # a failed store costs the next run a rescan


def _scan_partition(fmt, path: str, *, with_moments: bool) -> _PartitionEntry:
    """One partition's reductions through the format's own file scan
    (selected keys, zero values kept in widths; the intercept is the
    caller's), with the moment partials when asked."""
    keys: set = set()
    rows, max_live = fmt.scan_file(path, keys)
    entry = _PartitionEntry(rows=rows, max_live=max_live, keys=sorted(keys))
    if with_moments:
        entry.real_rows, entry.moments = _moment_partials(fmt, path)
        entry.has_moments = True
    return entry


def _moment_partials(fmt, path: str):
    """Raw float64 per-key partials of one partition, added entry by entry
    in file order (the fused scan's accumulation, stopped before
    finalize)."""
    real_rows = 0.0
    s: Dict[str, List[float]] = {}

    def add(key, v: float) -> None:
        m = s.get(key)
        if m is None:
            m = s[key] = [0.0, 0.0, 0.0, 0.0, -np.inf, np.inf]
        m[0] += v
        m[1] += v * v
        m[2] += abs(v)
        m[3] += 1.0
        m[4] = max(m[4], v)
        m[5] = min(m[5], v)

    decoded = getattr(fmt, "decode_file", lambda p: None)(path)
    if decoded is not None:
        m_rec = decoded.num_records
        sel = np.asarray(
            [fmt.selected is None or x in fmt.selected for x in decoded.strings], dtype=bool
        )
        wgt = decoded.f64("weight") if "weight" in decoded.plan.num_slots else np.ones(m_rec)
        real = np.where(np.isnan(wgt), 1.0, wgt) > 0
        real_rows = float(real.sum())
        row_ptr, key_ids, values = decoded.bag("features")
        if len(key_ids):
            row_of = np.repeat(np.arange(m_rec, dtype=np.int64), np.diff(row_ptr))
            keep = sel[key_ids] & real[row_of] & (values != 0)
            # per interned string, in entry order: np.add.at applies the
            # additions in order, so each key's sums are the entry-by-entry
            # loop's, bit for bit
            ks, v = key_ids[keep].astype(np.int64), values[keep].astype(np.float64)
            n = len(decoded.strings)
            cols = [np.zeros(n) for _ in range(4)] + [np.full(n, -np.inf), np.full(n, np.inf)]
            np.add.at(cols[0], ks, v)
            np.add.at(cols[1], ks, v * v)
            np.add.at(cols[2], ks, np.abs(v))
            np.add.at(cols[3], ks, 1.0)
            np.maximum.at(cols[4], ks, v)
            np.minimum.at(cols[5], ks, v)
            for kid in np.unique(ks).tolist():
                s[decoded.strings[kid]] = [float(c[kid]) for c in cols]
    else:
        for record in read_avro_records([path]):
            wgt_v = record.get("weight")
            real = (1.0 if wgt_v is None else float(wgt_v)) > 0
            real_rows += 1.0 if real else 0.0
            for key, value in fmt._record_pairs(record):
                if real and value != 0:
                    add(key, value)
    return real_rows, {k: tuple(v) for k, v in s.items()}


def _gather_entries(
    paths, fmt, cache: PartitionStatsCache, *, with_moments: bool
) -> List[Tuple[str, _PartitionEntry]]:
    out = []
    cache.stats = ScanCacheStats()
    for path in fmt.stream_files(paths):
        cache.stats.partitions += 1
        key = _partition_key(path)
        entry = cache.load(path, key)
        if entry is not None and (not with_moments or entry.has_moments):
            cache.stats.cached += 1
        else:
            cache.stats.scanned += 1
            entry = _scan_partition(fmt, path, with_moments=with_moments)
            cache.store(path, key, entry)
        out.append((path, entry))
    return out


def _merged_shape(entries, fmt, index_map):
    keys = set()
    num_rows = 0
    max_live = 0
    for _path, e in entries:
        num_rows += e.rows
        max_live = max(max_live, e.max_live)
        if index_map is None:
            keys.update(e.keys)
    if index_map is None:
        index_map = IndexMap.build(iter(keys), add_intercept=fmt.add_intercept)
    max_nnz = max(max_live + (1 if fmt.add_intercept else 0), 1)
    return index_map, StreamStats(num_rows=num_rows, max_nnz=max_nnz)


def cached_scan_stream(paths, fmt, cache_dir: str, *, index_map=None):
    """``io.streaming.scan_stream`` over an append-only directory: the
    IDENTICAL (index_map, StreamStats), reading only the partitions
    without a valid entry. -> (index_map, StreamStats, ScanCacheStats)."""
    cache = PartitionStatsCache(cache_dir)
    entries = _gather_entries(paths, fmt, cache, with_moments=False)
    index_map, stats = _merged_shape(entries, fmt, index_map)
    return index_map, stats, cache.stats


def cached_scan_stream_with_summary(
    paths, fmt, cache_dir: str, *, index_map=None, device: DeviceLike = None
):
    """Cached twin of ``stream_scan_with_summary``: the vocabulary, the
    shape stats and the colStats summary (on ``device``) from the
    per-partition partials. -> (index_map, StreamStats, summary,
    ScanCacheStats)."""
    cache = PartitionStatsCache(cache_dir)
    entries = _gather_entries(paths, fmt, cache, with_moments=True)
    index_map, stats = _merged_shape(entries, fmt, index_map)
    dim = index_map.size
    s1, s2, l1, nnz = (np.zeros(dim) for _ in range(4))
    mx = np.full(dim, -np.inf)
    mn = np.full(dim, np.inf)
    real_rows = 0.0
    # merge in sorted-file order (the gather order): deterministic
    for _path, e in entries:
        real_rows += e.real_rows
        for key, (p1, p2, pl1, pn, pmx, pmn) in e.moments.items():
            j = index_map.get_index(key)
            if j < 0:
                continue
            s1[j] += p1
            s2[j] += p2
            l1[j] += pl1
            nnz[j] += pn
            mx[j] = max(mx[j], pmx)
            mn[j] = min(mn[j], pmn)
    icept = index_map.get_index(intercept_key()) if fmt.add_intercept else -1
    summary = summary_from_moments(
        (s1, s2, l1, nnz, mx, mn), icept if icept >= 0 else None, real_rows, device=device
    )
    return index_map, stats, summary, cache.stats
