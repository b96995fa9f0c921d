"""Python binding for the native mmap index store, the PalDB analog (port
of ``photon_ml_tpu/utils/native_index.py``). It loads the same C++ source,
``native/index_store.cpp``, and builds it with g++ into the port's build
directory (``utils.device.build_dir``) at first use, as
``io/native_avro.py`` builds the Avro decoder. A build that fails raises:
there is no Python fallback for an off-heap store.

Reference: photon-ml .../util/PalDBIndexMap.scala:43-130 (partitioned
off-heap stores with offset arrays + per-partition local indices, global
index = local + partition offset; readers guarded by PALDB_READER_LOCK —
unnecessary here, the mmap is immutable and lock-free) and
PalDBIndexMapBuilder.scala / PalDBIndexMapLoader.scala,
FeatureIndexingJob.scala:59-136 (hash-partitioned vocabulary build).

ctypes keeps the binding dependency-free. Stores are byte-compatible across
the two packages: a store built by either opens in the other.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import threading
from typing import Iterable, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.reliability.artifacts import atomic_writer
from photon_ml_tpu_torch.utils.device import build_dir

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "index_store.cpp")
_COMPILE_LOCK = threading.Lock()
_lib_handle = None


def _compile_if_needed() -> str:
    """The built library's path; builds it when missing or older than the
    source (temp file + rename: another process never loads a half-written
    library)."""
    lib = os.path.join(build_dir(), "libindex_store.so")
    with _COMPILE_LOCK:
        if os.path.isfile(lib) and os.path.getmtime(lib) >= os.path.getmtime(_SRC):
            return lib
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, lib)
        return lib


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(_compile_if_needed())
        lib.pidx_build.restype = ctypes.c_int
        lib.pidx_build.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint64,
        ]
        lib.pidx_open.restype = ctypes.c_void_p
        lib.pidx_open.argtypes = [ctypes.c_char_p]
        lib.pidx_close.argtypes = [ctypes.c_void_p]
        lib.pidx_size.restype = ctypes.c_uint64
        lib.pidx_size.argtypes = [ctypes.c_void_p]
        lib.pidx_get_index.restype = ctypes.c_int64
        lib.pidx_get_index.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.pidx_get_key.restype = ctypes.c_int64
        lib.pidx_get_key.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.pidx_get_indices.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib_handle = lib
    return _lib_handle


def build_store(path: str, keys: Sequence[str]) -> None:
    """Write one partition store; keys get local indices 0..n-1."""
    lib = _lib()
    encoded = [k.encode("utf-8") for k in keys]
    n = len(encoded)
    arr = (ctypes.c_char_p * n)(*encoded)
    lens = (ctypes.c_uint32 * n)(*[len(e) for e in encoded])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = lib.pidx_build(path.encode(), arr, lens, n)
    if rc == -2:
        raise ValueError("duplicate keys in index store build")
    if rc != 0:
        raise OSError(f"pidx_build failed with code {rc}")


class NativeIndexStore:
    """One open partition store (immutable, lock-free reads)."""

    def __init__(self, path: str):
        self._lib = _lib()
        self._handle = self._lib.pidx_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open index store {path}")
        self.path = path

    def __len__(self) -> int:
        return self._lib.pidx_size(self._handle)

    def get_index(self, key: str) -> int:
        e = key.encode("utf-8")
        return self._lib.pidx_get_index(self._handle, e, len(e))

    def get_key(self, local_index: int) -> Optional[str]:
        buf = ctypes.create_string_buffer(4096)
        n = self._lib.pidx_get_key(self._handle, local_index, buf, 4096)
        if n < 0:
            return None
        if n > 4096:
            buf = ctypes.create_string_buffer(n)
            self._lib.pidx_get_key(self._handle, local_index, buf, n)
        return buf.raw[:n].decode("utf-8")

    def get_indices(self, keys: Sequence[str]) -> np.ndarray:
        encoded = [k.encode("utf-8") for k in keys]
        packed = b"".join(encoded)
        offsets = np.zeros(len(encoded) + 1, np.uint64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        out = np.empty(len(encoded), np.int64)
        self._lib.pidx_get_indices(
            self._handle,
            packed,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(encoded),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.pidx_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class PartitionedIndexMap:
    """IndexMap API over hash-partitioned native stores
    (PalDBIndexMap semantics: partition = hash(key) %% P, global index =
    local + offset[partition])."""

    STORE_PATTERN = "index-partition-{part}.pidx"

    def __init__(self, directory: str):
        self.directory = directory
        # sort by NUMERIC partition id: lexicographic order would place
        # partition 10 before 2 and misalign hash(key) % P routing
        parts = sorted(
            (
                f
                for f in os.listdir(directory)
                if f.startswith("index-partition-")
            ),
            key=lambda f: int(
                f[len("index-partition-"):].split(".", 1)[0]
            ),
        )
        if not parts:
            raise OSError(f"no index partitions in {directory}")
        expected = [
            self.STORE_PATTERN.format(part=p) for p in range(len(parts))
        ]
        if parts != expected:
            raise OSError(
                f"{directory}: partition files {parts} are not the "
                f"contiguous set {expected}"
            )
        self._stores = [
            NativeIndexStore(os.path.join(directory, f)) for f in parts
        ]
        self._offsets = np.zeros(len(self._stores) + 1, np.int64)
        np.cumsum([len(s) for s in self._stores], out=self._offsets[1:])

    @property
    def size(self) -> int:
        return int(self._offsets[-1])

    def __len__(self) -> int:
        return self.size

    def __contains__(self, key: str) -> bool:
        return self.get_index(key) >= 0

    def _partition_of(self, key: str) -> int:
        import zlib

        return zlib.crc32(key.encode("utf-8")) % len(self._stores)

    def get_index(self, key: str, default: int = -1) -> int:
        p = self._partition_of(key)
        local = self._stores[p].get_index(key)
        return int(local + self._offsets[p]) if local >= 0 else default

    def get_feature_name(self, index: int) -> Optional[str]:
        p = int(np.searchsorted(self._offsets, index, side="right")) - 1
        if p < 0 or p >= len(self._stores):
            return None
        return self._stores[p].get_key(index - int(self._offsets[p]))

    def items(self):
        for p, store in enumerate(self._stores):
            base = int(self._offsets[p])
            for local in range(len(store)):
                yield store.get_key(local), base + local

    def close(self) -> None:
        for s in self._stores:
            s.close()

    def save(self, path: str) -> None:
        """Write a POINTER to the store instead of duplicating a
        potentially >200k-key vocabulary as JSON (IndexMap.save parity
        for the driver's feature-index output). ``IndexMap.load``
        recognizes the pointer and reopens the store; the relative path
        keeps an output directory relocatable together with its index."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with atomic_writer(path, encoding="utf-8") as f:
            json.dump(
                {
                    "offheap_index_store": os.path.abspath(self.directory),
                    "offheap_index_store_relative": os.path.relpath(
                        os.path.abspath(self.directory),
                        os.path.dirname(os.path.abspath(path)),
                    ),
                    "num_partitions": len(self._stores),
                    "size": self.size,
                },
                f,
            )

    @staticmethod
    def from_pointer(meta: dict, pointer_path: str) -> "PartitionedIndexMap":
        """Reopen a store from a ``save`` pointer; tries the relative
        path (relocated output tree) before the recorded absolute one."""
        rel = meta.get("offheap_index_store_relative")
        if rel is not None:
            cand = os.path.join(
                os.path.dirname(os.path.abspath(pointer_path)), rel
            )
            if _has_store(cand):
                return PartitionedIndexMap(cand)
        return PartitionedIndexMap(meta["offheap_index_store"])


def build_partitioned_index(
    keys: Iterable[str],
    directory: str,
    num_partitions: int = 1,
) -> PartitionedIndexMap:
    """The FeatureIndexingJob analog: hash-partition DISTINCT keys, build
    one native store per partition (sorted within partition for
    determinism), return the loader."""
    import zlib

    os.makedirs(directory, exist_ok=True)
    parts: List[List[str]] = [[] for _ in range(num_partitions)]
    for key in sorted(set(keys)):
        parts[zlib.crc32(key.encode("utf-8")) % num_partitions].append(key)
    for p, part_keys in enumerate(parts):
        build_store(
            os.path.join(
                directory, PartitionedIndexMap.STORE_PATTERN.format(part=p)
            ),
            sorted(part_keys),
        )
    return PartitionedIndexMap(directory)


def load_offheap_index_map(
    directory: str,
    shard_name: Optional[str] = None,
    num_partitions: Optional[int] = None,
) -> PartitionedIndexMap:
    """Open a prebuilt partitioned store (the drivers'
    ``--offheap-indexmap-dir`` path; PalDBIndexMapLoader analog,
    cli/game/GAMEDriver.scala:89-97 prepareFeatureMaps).

    With ``shard_name`` (the GAME per-shard path) the store MUST be at
    ``<directory>/<shard_name>`` — pointing different shards at one store
    would silently merge their feature spaces. Without it, accepts either
    a store directory itself (contains ``index-partition-*``) or a parent
    with exactly one shard subdirectory. ``num_partitions`` — the
    reference's ``offheap-indexmap-num-partitions`` — is validated
    against the store when given (here partition count is discovered
    from the files, so the option is a consistency check only).
    """
    if shard_name is not None:
        d = os.path.join(directory, shard_name)
        if not _has_store(d):
            raise OSError(
                f"no index store for feature shard {shard_name!r} at {d} "
                "— run the feature-indexing job with "
                f"--shard-name {shard_name}"
            )
    else:
        d = directory
        if not _has_store(d):
            subs = [
                s
                for s in sorted(os.listdir(d))
                if _has_store(os.path.join(d, s))
            ] if os.path.isdir(d) else []
            if len(subs) != 1:
                raise OSError(
                    f"{directory}: expected an index store or exactly one "
                    f"shard subdirectory, found {subs or 'none'}"
                )
            d = os.path.join(d, subs[0])
    pm = PartitionedIndexMap(d)
    if num_partitions is not None and len(pm._stores) != num_partitions:
        pm.close()
        raise ValueError(
            f"offheap index map at {d} has {len(pm._stores)} partitions, "
            f"expected {num_partitions}"
        )
    return pm


def load_offheap_index_maps(
    directory: str,
    shard_ids: Sequence[str],
    num_partitions: Optional[int] = None,
) -> dict:
    """{shard_id: PartitionedIndexMap} for the GAME drivers'
    --offheap-indexmap-dir (prepareFeatureMaps analog); every shard must
    have its ``<directory>/<shard_id>`` store."""
    return {
        sid: load_offheap_index_map(
            directory, shard_name=sid, num_partitions=num_partitions
        )
        for sid in shard_ids
    }


def _has_store(d: str) -> bool:
    return os.path.isdir(d) and any(
        f.startswith("index-partition-") for f in os.listdir(d)
    )
