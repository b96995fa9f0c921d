"""Persistent content-addressed cache for tiled sparse schedules (port of
``photon_ml_tpu/ops/schedule_cache.py``, with the same on-disk format: an
artifact written by either package loads in the other).

The schedule is a pure function of (entry coordinates and values, tile
params, output-block count), and building it is the cold fit's largest
host cost after loading the data. This module keeps one versioned
artifact per built schedule, keyed by a content hash of the inputs, and
loads it back as ``np.load(mmap_mode='r')`` views with cheap integrity
checks, falling back to a rebuild on any mismatch.

Layout on disk (one directory per schedule)::

    <cache_dir>/v<VERSION>/<key>/
        meta.json          # version, key, per-array dtype/shape/nbytes/spot
        step_out.npy ... spill_vals.npy   # the 9 schedule arrays

Integrity: each ``.npy`` carries a SPOT digest (blake2b over the first
and last 64 KiB of the file plus its size) recorded in meta.json. That
catches truncation, header damage and version skew in O(1) IO; the
content-addressed key already ties the artifact to its exact inputs.

Several processes: every key is stored by exactly one process. In the
JAX package every process builds the same global layout, so process 0
writes and the others wait for its artifacts. A rank of the port's mesh
builds only its own cell, whose key no other rank of the mesh computes, so
the builder of a schedule names the processes that build the same one
(``builders``: the ranks of other replica blocks holding the same cell;
``None`` means every process, the JAX package's case). The lowest of them
writes; the others wait for its artifact (``wait_and_load``), and on a
timeout build locally without storing. A process that alone builds a key
writes it and never waits. ``PHOTON_TILE_CACHE_WRITER=0|1`` forces the
role. Stores are atomic (temp dir + rename), so a reader never sees a
half-written artifact.

Configuration precedence: ``cache_scope`` (innermost, the trainers'
``tile_cache_dir``) > ``configure`` > the ``PHOTON_TILE_CACHE_DIR`` env
var > off. Unset means OFF.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.reliability.retry import (
    SeamFailure,
    io_call,
    quarantine_artifact,
)

logger = logging.getLogger(__name__)

# Bump whenever the schedule array layout or builder semantics change:
# the version is part of both the artifact path and meta.json, so old
# artifacts simply miss and are rebuilt.
SCHEDULE_CACHE_VERSION = 1

ENV_CACHE_DIR = "PHOTON_TILE_CACHE_DIR"
ENV_WAIT_S = "PHOTON_TILE_CACHE_WAIT_S"
ENV_WRITER = "PHOTON_TILE_CACHE_WRITER"

SCHEDULE_ARRAY_NAMES = (
    "step_out", "step_in", "step_init", "out_pos", "in_pos", "vals",
    "spill_out", "spill_in", "spill_vals",
)

_SPOT_BYTES = 64 * 1024

# -- configuration -----------------------------------------------------------

_configured: Optional[str] = None
_configured_set = False
_scoped: list = []  # innermost-last stack of explicit cache dirs
_lock = threading.Lock()


def configure(cache_dir: Optional[str]) -> None:
    """Process-wide cache directory. ``configure(None)`` restores the
    env-var default; ``configure("")`` disables the cache outright."""
    global _configured, _configured_set
    _configured = cache_dir
    _configured_set = cache_dir is not None


@contextmanager
def cache_scope(cache_dir: Optional[str]):
    """Scoped override for library callers (the trainers) that thread an
    explicit ``tile_cache_dir`` argument. ``None`` is a
    no-op passthrough (an outer scope, ``configure`` or the env var still
    applies)."""
    if cache_dir is None:
        yield
        return
    with _lock:
        _scoped.append(cache_dir)
    try:
        yield
    finally:
        with _lock:
            _scoped.pop()


def resolve_cache_dir() -> Optional[str]:
    """The active cache directory, or None when the cache is off."""
    with _lock:
        if _scoped:
            return _scoped[-1] or None
    if _configured_set:
        return _configured or None
    return os.environ.get(ENV_CACHE_DIR) or None


# -- stats (the observable seam: hit/miss/build counters + timers) ----------


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    builds: int = 0  # schedules actually built (disk hit skips this)
    corrupt: int = 0  # artifacts rejected (version/checksum/shape)
    quarantined: int = 0  # rejected artifacts renamed to *.corrupt
    stores: int = 0
    hash_s: float = 0.0
    load_s: float = 0.0
    store_s: float = 0.0
    build_s: float = 0.0
    wait_s: float = 0.0  # a non-writer polling for another process's artifact

    def as_dict(self) -> Dict[str, float]:
        return asdict(self)


_stats = CacheStats()
_stats_lock = threading.Lock()


def stats() -> CacheStats:
    """Snapshot of the process-wide cache counters."""
    with _stats_lock:
        return CacheStats(**asdict(_stats))


def reset_stats() -> None:
    global _stats
    with _stats_lock:
        _stats = CacheStats()


def _bump(counter: str, n: int = 1) -> None:
    with _stats_lock:
        setattr(_stats, counter, getattr(_stats, counter) + n)


def _add_time(bucket: str, seconds: float) -> None:
    with _stats_lock:
        setattr(_stats, bucket, getattr(_stats, bucket) + seconds)


def record_build_seconds(seconds: float) -> None:
    """Called by the schedule builder for every build, so build time lands
    in the same stats as the cache's own load/store timers."""
    _bump("builds")
    _add_time("build_s", seconds)


# -- content addressing ------------------------------------------------------


def content_digest(*arrays: np.ndarray) -> str:
    """blake2b hex digest over the arrays' dtype/shape/bytes. Arrays are
    hashed on worker threads (hashlib releases the GIL for large buffers),
    so the three COO columns digest in parallel."""
    t0 = time.perf_counter()

    def one(a: np.ndarray) -> bytes:
        a = np.ascontiguousarray(a)
        h = hashlib.blake2b(digest_size=16)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(memoryview(a).cast("B"))
        return h.digest()

    arrays = tuple(arrays)
    if len(arrays) > 1:
        with ThreadPoolExecutor(len(arrays)) as pool:
            parts = list(pool.map(one, arrays))
    else:
        parts = [one(a) for a in arrays]
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(p)
    out = h.hexdigest()
    _add_time("hash_s", time.perf_counter() - t0)
    return out


def _params_repr(params) -> str:
    """The JAX package's ``repr(TileParams)``, so both packages key a
    schedule alike. Its ``split`` knob (independent compute chains in the
    TPU kernel) has no counterpart in the port and keeps its default 1."""
    return (
        f"TileParams(s_hi={params.s_hi}, s_lo={params.s_lo}, "
        f"chunk={params.chunk}, split=1, spill_cap={params.spill_cap})"
    )


def schedule_key(
    digest: str,
    params,
    sort_by_feature_block: bool,
    num_out_blocks: int,
) -> str:
    """Cache key for one built schedule: the entry-content digest plus
    everything else the build depends on (tile params incl. the RESOLVED
    chunk, pass direction, output-block count, layout version)."""
    canon = "|".join(
        (
            f"v{SCHEDULE_CACHE_VERSION}",
            digest,
            _params_repr(params),
            f"feat_sorted={int(bool(sort_by_feature_block))}",
            f"out_blocks={int(num_out_blocks)}",
        )
    )
    return hashlib.blake2b(canon.encode(), digest_size=16).hexdigest()


# -- roles across processes --------------------------------------------------


def is_cache_writer(builders: Optional[Sequence[int]] = None) -> bool:
    """Whether this process stores the schedules it builds: the lowest of
    ``builders`` (the processes that build the same key; ``None`` = every
    process, so process 0). ``PHOTON_TILE_CACHE_WRITER=0|1`` overrides
    (tests, external orchestration)."""
    forced = os.environ.get(ENV_WRITER)
    if forced is not None:
        return forced.strip() not in ("0", "false", "no", "")
    # multihost imports torch.distributed: only a cache user pays for it
    from photon_ml_tpu_torch.parallel import multihost

    me = multihost.process_index()
    return me == (0 if builders is None else min(builders))


def _wait_deadline_s() -> float:
    try:
        return float(os.environ.get(ENV_WAIT_S, "300"))
    except ValueError:
        return 300.0


# -- disk artifacts ----------------------------------------------------------


def _artifact_dir(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"v{SCHEDULE_CACHE_VERSION}", key)


def _spot_digest(path: str) -> str:
    """Cheap integrity fingerprint: blake2b over the first and last
    64 KiB of the file plus its size — O(1) IO regardless of artifact
    size, catches truncation and header/tail damage."""
    size = os.path.getsize(path)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(_SPOT_BYTES))
        if size > _SPOT_BYTES:
            f.seek(max(size - _SPOT_BYTES, 0))
            h.update(f.read(_SPOT_BYTES))
    return h.hexdigest()


def store_schedule(
    cache_dir: str, key: str, arrays: Sequence[np.ndarray]
) -> bool:
    """Write one schedule artifact atomically (temp dir + rename).
    Returns False (without raising) on any IO failure — the cache is an
    accelerator, never a correctness dependency."""
    if len(arrays) != len(SCHEDULE_ARRAY_NAMES):
        raise ValueError(
            f"expected {len(SCHEDULE_ARRAY_NAMES)} schedule arrays, "
            f"got {len(arrays)}"
        )
    t0 = time.perf_counter()
    final = _artifact_dir(cache_dir, key)
    tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"

    def _store_once() -> bool:
        if os.path.isdir(final):
            return True  # already stored (concurrent writer won)
        os.makedirs(tmp, exist_ok=True)

        def write_one(item: Tuple[str, np.ndarray]) -> Tuple[str, dict]:
            name, a = item
            a = np.ascontiguousarray(a)
            path = os.path.join(tmp, f"{name}.npy")
            np.save(path, a)
            return name, {
                "dtype": a.dtype.str,
                "shape": list(a.shape),
                "nbytes": int(a.nbytes),
                "spot": _spot_digest(path),
            }

        with ThreadPoolExecutor(min(4, len(arrays))) as pool:
            meta_arrays = dict(
                pool.map(write_one, zip(SCHEDULE_ARRAY_NAMES, arrays))
            )
        meta = {
            "version": SCHEDULE_CACHE_VERSION,
            "key": key,
            "arrays": meta_arrays,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        try:
            os.rename(tmp, final)
        except OSError:
            # another writer renamed first — theirs is equivalent
            shutil.rmtree(tmp, ignore_errors=True)
        _bump("stores")
        return True

    try:
        # cache_store seam: transient write errors retry into a fresh
        # temp-dir attempt (the temp+rename protocol is idempotent)
        return io_call("cache_store", _store_once, detail=final)
    except SeamFailure as e:  # disk full, permissions: the budget is spent
        logger.warning("tile-schedule cache store failed (%s): %s", key, e)
        shutil.rmtree(tmp, ignore_errors=True)
        return False
    finally:
        _add_time("store_s", time.perf_counter() - t0)


def _quarantine_artifact_dir(d: str, key: str, why: str) -> None:
    """A rejected artifact must not fail every future run: rename the
    whole artifact directory to ``*.corrupt`` (accounted in both the
    cache stats and the reliability quarantine list) so the next run
    rebuilds and re-stores a clean copy instead of re-tripping on the
    poison forever."""
    dst = quarantine_artifact(d, "cache_load")
    if dst is not None:
        _bump("quarantined")
        logger.warning(
            "tile-schedule cache artifact %s quarantined to %s (%s)",
            key, dst, why,
        )


def load_schedule(
    cache_dir: str, key: str
) -> Optional[Tuple[np.ndarray, ...]]:
    """Load one schedule artifact as mmap-backed read-only arrays, or
    None on miss / version skew / corruption (callers rebuild). Runs
    behind the ``cache_load`` seam: transient IO errors retry; an
    artifact still failing (or failing integrity checks) is QUARANTINED
    (renamed ``*.corrupt``) so it cannot poison future runs."""
    t0 = time.perf_counter()
    d = _artifact_dir(cache_dir, key)
    meta_path = os.path.join(d, "meta.json")

    def _load_once() -> Optional[Tuple[np.ndarray, ...]]:
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("version") != SCHEDULE_CACHE_VERSION or meta.get(
            "key"
        ) != key:
            raise ValueError("version/key mismatch")
        out = []
        for name in SCHEDULE_ARRAY_NAMES:
            spec = meta["arrays"][name]
            path = os.path.join(d, f"{name}.npy")
            if _spot_digest(path) != spec["spot"]:
                raise ValueError(f"spot checksum mismatch for {name}")
            a = np.load(path, mmap_mode="r")
            if a.dtype.str != spec["dtype"] or list(a.shape) != list(
                spec["shape"]
            ):
                raise ValueError(f"dtype/shape mismatch for {name}")
            out.append(a)
        return tuple(out)

    try:
        if not os.path.isfile(meta_path):
            _bump("misses")
            return None
        out = io_call("cache_load", _load_once, detail=d)
        _bump("hits")
        return out
    except (ValueError, KeyError, json.JSONDecodeError) as e:
        # artifact damage: re-reading yields the same bytes — quarantine
        _bump("corrupt")
        _bump("misses")
        _quarantine_artifact_dir(d, key, str(e))
        return None
    except (SeamFailure, OSError) as e:
        # persistent IO trouble on this artifact: same quarantine path
        # (the cache is an accelerator, never a correctness dependency)
        logger.warning(
            "tile-schedule cache artifact %s unreadable, rebuilding: %s",
            key, e,
        )
        _bump("corrupt")
        _bump("misses")
        _quarantine_artifact_dir(d, key, str(e))
        return None
    finally:
        _add_time("load_s", time.perf_counter() - t0)


def wait_and_load(
    cache_dir: str, key: str, timeout_s: Optional[float] = None
) -> Optional[Tuple[np.ndarray, ...]]:
    """A non-writer: poll for the writer's artifact until the deadline
    (``PHOTON_TILE_CACHE_WAIT_S``, 300 s), then give up (the caller builds
    locally, without storing). The store is atomic, so the first load
    that finds ``meta.json`` is complete."""
    deadline = time.monotonic() + (
        timeout_s if timeout_s is not None else _wait_deadline_s()
    )
    t0 = time.perf_counter()
    try:
        while True:
            if os.path.isfile(os.path.join(_artifact_dir(cache_dir, key), "meta.json")):
                return load_schedule(cache_dir, key)
            if time.monotonic() >= deadline:
                logger.warning(
                    "timed out waiting for tile-schedule artifact %s; "
                    "building locally", key,
                )
                return None
            time.sleep(0.05)
    finally:
        _add_time("wait_s", time.perf_counter() - t0)


# -- bounded in-memory LRU (the two tiers in front of the disk cache) --------


class ScheduleLRU:
    """Small bounded LRU for converted batches: a hit refreshes recency,
    an insert evicts the LEAST recently used entry. One instance each for
    the tiled and the sharded conversions (``ops/tiled_sparse.py``), so the
    two cannot evict each other."""

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self._d: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key not in self._d:
                return None
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
            self._d[key] = value
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def pop(self, key) -> None:
        with self._lock:
            self._d.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def keys(self):
        with self._lock:
            return list(self._d.keys())
