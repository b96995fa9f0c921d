"""Out-of-core GAME training: streamed coordinate descent over spilled
chunks under a host-memory budget (port of
``photon_ml_tpu/game/streaming.py``, single process).

Reference: the reference pipeline is passes over RDDs (prepare,
DataProcessingUtils.scala; per-entity grouping,
RandomEffectDataSet.scala:169-369; coordinate updates,
CoordinateDescent.scala:130-262) with Spark spilling what exceeds memory.
Here, on one host:

- **Scan** (:func:`scan_game_stream`): one bounded pass for per-shard
  vocabularies, entity indexes and active counts, the row count and the
  staging widths.
- **Stage** (:func:`stage_game_stream`): rows stream once into fixed-shape
  chunks spilled to scratch (:class:`GameChunkStore`), sized by
  ``--stream-memory-budget``; with a persistent directory a killed stage
  resumes from its completed chunks.
- **Streamed CD** (:class:`StreamingCoordinateDescent`): the fixed effect
  trains through the host optimizers over a chunk objective with the
  residual folded into offsets chunk by chunk (the scatter partial, as in
  the reference); random effects solve segment by segment from a disk
  grouping (:class:`SpilledREBuckets`, a scatter with no sort); scores and
  residuals live on disk per chunk (:class:`ScoreStore`).

Host memory holds one staged chunk + one bucket segment + the models.
Scope (validated up front): the IDENTITY projector, no active-data cap,
plain (non-factored) coordinates. With an entity mesh
(``train_streaming_game(entity_mesh=)``) each random-effect bank lives
sharded over its ranks by entity hash (``game/pod.py``): every rank runs
the same pipeline over the same files, stages and solves only its own
hash shard of each segment, and the chunk scores are summed over the ranks.
"""

from __future__ import annotations

import itertools
import os
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.game.config import (
    FeatureShardConfiguration,
    FixedEffectDataConfiguration,
    ProjectorType,
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.game.data import (
    EntityIndex,
    _padded_width,
    record_entity_id,
    record_response,
)
from photon_ml_tpu_torch.io.avro_codec import read_avro_records
from photon_ml_tpu_torch.io.paths import expand_input_paths
from photon_ml_tpu_torch.io.streaming import (
    _prefetched,
    budgeted_rows,
    make_spill_dir,
    sparse_row_bytes,
    stream_budget_rows,
    unregister_spill_dir,
)
from photon_ml_tpu_torch.ops.kernels import entity_products
from photon_ml_tpu_torch.ops.objective import (
    GLMObjective,
    partial_hessian_diagonal,
    partial_hessian_vector,
    partial_value_and_gradient,
)
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.reliability.manifest import ensure_run_manifest, write_manifest
from photon_ml_tpu_torch.reliability.retry import io_call
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.utils.index_map import IndexMap, feature_key, intercept_key
from photon_ml_tpu_torch.utils.logging_util import PhotonLogger

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# scan pass
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GameStreamStats:
    """One scan's results, fixing every later pass's shapes."""

    num_rows: int
    shard_nnz: Dict[str, int]  # padded per-row width per shard (with the intercept)
    # ACTIVE (weight > 0) rows per entity code, per RE type: the bucket
    # capacities without a grouping pass
    entity_counts: Dict[str, np.ndarray]


def _game_files(paths) -> List[str]:
    files = sorted(expand_input_paths(list(paths), lambda fn: fn.endswith(".avro")))
    if not files:
        raise ValueError(f"no .avro inputs under {paths!r}")
    return files


def _stream_records(paths):
    """Records, ONE file resident at a time; each file's decode is the
    retryable unit behind the ``chunk_read`` seam."""
    for path in _game_files(paths):
        yield from io_call(
            "chunk_read", lambda path=path: list(read_avro_records([path])), detail=path,
        )


def scan_game_stream(
    paths,
    shard_configs: Sequence[FeatureShardConfiguration],
    re_types: Sequence[str],
    *,
    index_maps: Optional[Mapping[str, IndexMap]] = None,
) -> Tuple[Dict[str, IndexMap], Dict[str, EntityIndex], GameStreamStats]:
    """One bounded pass: per-shard vocabularies (a prebuilt map skips its
    shard's), entity id sets and active counts, the row count and the
    per-shard max nnz. Entity codes and feature indices come out as the
    in-memory builder gives them (both sort), so the streamed fit trains
    in the same index space."""
    key_sets: Dict[str, set] = {
        cfg.shard_id: set()
        for cfg in shard_configs
        if index_maps is None or cfg.shard_id not in index_maps
    }
    max_live: Dict[str, int] = {cfg.shard_id: 0 for cfg in shard_configs}
    id_counts: Dict[str, Dict[str, int]] = {t: {} for t in re_types}
    num_rows = 0
    for r in _stream_records(paths):
        wgt_v = r.get("weight")
        w = 1.0 if wgt_v is None else float(wgt_v)
        for cfg in shard_configs:
            live = 0
            for bag in cfg.feature_bags:
                for f in r.get(bag) or []:
                    live += 1
                    if cfg.shard_id in key_sets:
                        key_sets[cfg.shard_id].add(feature_key(f["name"], f["term"]))
            max_live[cfg.shard_id] = max(max_live[cfg.shard_id], live)
        for t in re_types:
            rid = record_entity_id(r, t)
            c = id_counts[t]
            c[rid] = c.get(rid, 0) + (1 if w > 0 else 0)
        num_rows += 1
    if num_rows == 0:
        raise ValueError("empty GAME dataset")
    imaps: Dict[str, IndexMap] = {}
    for cfg in shard_configs:
        if index_maps is not None and cfg.shard_id in index_maps:
            imaps[cfg.shard_id] = index_maps[cfg.shard_id]
        else:
            imaps[cfg.shard_id] = IndexMap.build(
                iter(key_sets[cfg.shard_id]), add_intercept=cfg.add_intercept
            )
    entity_indexes: Dict[str, EntityIndex] = {}
    entity_counts: Dict[str, np.ndarray] = {}
    for t in re_types:
        eidx = EntityIndex.build(t, id_counts[t].keys())
        entity_indexes[t] = eidx
        entity_counts[t] = np.asarray([id_counts[t][rid] for rid in eidx.ids], np.int64)
    shard_nnz = {
        cfg.shard_id: _padded_width(max_live[cfg.shard_id] + (1 if cfg.add_intercept else 0), 8)
        for cfg in shard_configs
    }
    return imaps, entity_indexes, GameStreamStats(
        num_rows=num_rows, shard_nnz=shard_nnz, entity_counts=entity_counts
    )


def game_row_bytes(shard_nnz: Mapping[str, int], num_re_types: int) -> int:
    """Staged bytes per row of a GAME chunk: every shard's padded slots,
    label / offset / weight and one int32 code per RE type."""
    return sum(sparse_row_bytes(k) - 12 for k in shard_nnz.values()) + 12 + 4 * num_re_types


# ---------------------------------------------------------------------------
# spilled stores
# ---------------------------------------------------------------------------


class GameChunkStore:
    """Fixed-shape staged GAME chunks spilled to scratch: labels / offsets
    / weights [R], an int32 entity-code column per RE type, a padded
    sparse (ix, v) pair per feature shard. The last chunk pads with
    weight-0 rows; chunk i's row j is global row ``i * R + j``, the join
    key of chunks, score stores and bucket row indexes.

    ``persist_dir``: the crash-safe mode. The store lives in that named
    directory with a manifest written atomically after every appended
    chunk; a killed stage resumes from the completed chunks (a torn
    trailing chunk is truncated away and staged again)."""

    def __init__(
        self,
        rows_per_chunk: int,
        shard_nnz: Mapping[str, int],
        re_types: Sequence[str],
        spill_dir: Optional[str] = None,
        *,
        persist_dir: Optional[str] = None,
    ):
        self.R = int(rows_per_chunk)
        self.shard_nnz = dict(shard_nnz)
        self.re_types = list(re_types)
        self.persistent = persist_dir is not None
        self._manifest: Dict[str, object] = {}
        self.count = 0
        self.num_real_rows = 0
        self._fields = (
            ["lab", "off", "wgt"]
            + [f"code__{t}" for t in self.re_types]
            + [x for s in self.shard_nnz for x in (f"ix__{s}", f"v__{s}")]
        )
        if not self.persistent:
            self.dir = make_spill_dir("photon-game-spill-", spill_dir)
            self._writers = {
                f: open(os.path.join(self.dir, f + ".bin"), "wb") for f in self._fields
            }
        else:
            self.dir = os.path.abspath(persist_dir)
            self._open_persistent()
        self._mm: Optional[Dict[str, np.memmap]] = None

    def _config(self) -> Dict[str, object]:
        return {
            "rows_per_chunk": self.R,
            "shard_nnz": dict(sorted(self.shard_nnz.items())),
            "re_types": list(self.re_types),
        }

    def _open_persistent(self) -> None:
        manifest = ensure_run_manifest(self.dir, self._config(), kind="game-chunk-store")
        self._manifest = manifest
        self.count = int(manifest.get("chunks", 0))
        self.num_real_rows = int(manifest.get("real_rows", 0))
        # reopen for append, truncated to the manifest's completed chunks
        self._writers = {}
        for f in self._fields:
            path = os.path.join(self.dir, f + ".bin")
            if not os.path.exists(path):
                open(path, "wb").close()
            fh = open(path, "r+b")
            per_chunk = int(np.dtype(self._dtype(f)).itemsize * int(np.prod(self._shape(f))))
            fh.truncate(self.count * per_chunk)
            self._writers[f] = fh

    def _sync_manifest(self, **extra) -> None:
        """Publish progress atomically (persistent stores only)."""
        if not self.persistent:
            return
        self._manifest.update(chunks=self.count, real_rows=self.num_real_rows, **extra)
        write_manifest(self.dir, self._manifest)

    @property
    def rows_consumed(self) -> int:
        """Records the appended chunks consumed (every staged record,
        weight 0 included): the resume skip count of a stage pass."""
        return self.num_real_rows

    @property
    def staged(self) -> bool:
        return bool(self._manifest.get("staged"))

    def mark_staged(self) -> None:
        self._sync_manifest(staged=True)

    def fill_done(self, tag: str) -> bool:
        return bool(self._manifest.get(f"fill__{tag}"))

    def mark_fill_done(self, tag: str) -> None:
        self._sync_manifest(**{f"fill__{tag}": True})

    def _shape(self, name: str) -> Tuple[int, ...]:
        if name.startswith(("ix__", "v__")):
            return (self.R, self.shard_nnz[name.split("__", 1)[1]])
        return (self.R,)

    def _dtype(self, name: str):
        return np.int32 if name.startswith(("ix__", "code__")) else np.float32

    def append(self, arrays: Mapping[str, np.ndarray], real_rows: int) -> None:
        for f in self._fields:
            a = np.ascontiguousarray(arrays[f], self._dtype(f))
            assert a.shape == self._shape(f), (f, a.shape)
            data = a.tobytes()
            w = self._writers[f]
            off = self.count * len(data)

            def _write(w=w, data=data, off=off):
                # a fixed offset per chunk: a retried attempt overwrites
                w.seek(off)
                w.write(data)

            io_call("spill_write", _write, detail=f"{self.dir}/{f}.bin[{self.count}]")
        self.count += 1
        self.num_real_rows += int(real_rows)
        if self.persistent:
            for w in self._writers.values():
                w.flush()
            self._sync_manifest()

    def finalize(self) -> None:
        for w in self._writers.values():
            w.close()
        self._mm = {
            f: np.memmap(
                os.path.join(self.dir, f + ".bin"), dtype=self._dtype(f), mode="r",
                shape=(self.count,) + self._shape(f),
            )
            for f in self._fields
        }

    def chunk(self, i: int) -> Dict[str, np.ndarray]:
        """ONE chunk's arrays (copies), behind the ``spill_read`` seam."""
        assert self._mm is not None, "finalize() the store before reading"
        return io_call(
            "spill_read", lambda: {f: np.array(self._mm[f][i]) for f in self._fields},
            detail=f"{self.dir}[{i}]",
        )

    @property
    def num_rows_padded(self) -> int:
        return self.count * self.R

    def score_store(self, name: str) -> "ScoreStore":
        return ScoreStore(self.dir, name, self.count, self.R)

    def close(self) -> None:
        for w in self._writers.values():
            if not w.closed:
                w.close()
        self._mm = None
        if self.persistent:
            # the resume currency outlives the process on purpose; the
            # driver removes it after a completed run
            return
        unregister_spill_dir(self.dir)
        shutil.rmtree(self.dir, ignore_errors=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ScoreStore:
    """One coordinate's row-aligned scores as a [num_chunks, R] float32
    file: read and written per chunk behind the spill seams, gathered by
    global row id through :meth:`flat`. Scores are recomputed from the
    coordinate states, so a resumed run makes the files anew."""

    def __init__(self, base_dir: str, name: str, num_chunks: int, R: int):
        self.path = os.path.join(base_dir, f"score__{name}.bin")
        self.num_chunks, self.R = num_chunks, R
        # zero-initialized: the scores of zero models
        self._mm = np.memmap(self.path, dtype=np.float32, mode="w+", shape=(num_chunks, R))

    def get_chunk(self, i: int) -> np.ndarray:
        return io_call("spill_read", lambda: np.array(self._mm[i]), detail=f"{self.path}[{i}]")

    def set_chunk(self, i: int, scores) -> None:
        if torch.is_tensor(scores):
            scores = scores.detach().cpu().numpy()
        data = np.asarray(scores, np.float32)

        def _write():
            self._mm[i] = data

        io_call("spill_write", _write, detail=f"{self.path}[{i}]")

    def flat(self) -> np.ndarray:
        """The [num_chunks * R] view, for global-row-id gathers."""
        return self._mm.reshape(-1)


def stage_game_stream(
    paths,
    shard_configs: Sequence[FeatureShardConfiguration],
    re_types: Sequence[str],
    index_maps: Mapping[str, IndexMap],
    entity_indexes: Mapping[str, EntityIndex],
    stats: GameStreamStats,
    *,
    rows_per_chunk: int,
    spill_dir: Optional[str] = None,
    strict_ids: bool = True,
    reservoir_rows: int = 0,
    seed: int = 0,
    persist_dir: Optional[str] = None,
) -> Tuple[GameChunkStore, Optional[Dict[str, np.ndarray]]]:
    """Stream the rows once into a spilled GameChunkStore. ``strict_ids``
    False codes an entity id absent from ``entity_indexes`` -1 (the
    validation staging: an unseen entity scores 0). ``reservoir_rows``: an
    algorithm-R sample of real rows for the GAME diagnostics, drawn with
    numpy ``default_rng(seed)`` as the reference draws it.
    ``persist_dir``: crash-safe staging; an interrupted pass resumes past
    ``store.rows_consumed`` records and a staged store returns at once. The
    staged bytes equal an uninterrupted pass's (only the reservoir, a
    diagnostics sample, differs on a resume)."""
    R = int(rows_per_chunk)
    store = GameChunkStore(R, stats.shard_nnz, re_types, spill_dir, persist_dir=persist_dir)
    if store.staged:
        store.finalize()
        return store, None
    skip_records = store.rows_consumed
    icepts = {
        cfg.shard_id: (
            index_maps[cfg.shard_id].get_index(intercept_key()) if cfg.add_intercept else -1
        )
        for cfg in shard_configs
    }
    rng = np.random.default_rng(seed)
    K = int(reservoir_rows)
    res = None
    if K:
        res = {f: np.zeros(K, np.float32) for f in ("lab", "off", "wgt")}
        for sid, k in stats.shard_nnz.items():
            res[f"ix__{sid}"] = np.zeros((K, k), np.int32)
            res[f"v__{sid}"] = np.zeros((K, k), np.float32)
    seen_real = 0

    def new_bufs():
        bufs = {f: np.zeros(R, np.float32) for f in ("lab", "off", "wgt")}
        for t in re_types:
            bufs[f"code__{t}"] = np.full(R, -1, np.int32)
        for sid, k in stats.shard_nnz.items():
            bufs[f"ix__{sid}"] = np.zeros((R, k), np.int32)
            bufs[f"v__{sid}"] = np.zeros((R, k), np.float32)
        return bufs

    bufs = new_bufs()
    fill = 0
    records = _stream_records(paths)
    if skip_records:
        # resume past the records the completed chunks hold
        records = itertools.islice(records, skip_records, None)
    from photon_ml_tpu_torch.parallel.overlap import overlap_enabled

    if overlap_enabled() and (os.cpu_count() or 1) > 1:
        # decode ahead on a worker thread while this one scatters
        records = _prefetched(records, depth=2 * R)
    for r in records:
        bufs["lab"][fill] = record_response(r)
        off_v = r.get("offset")
        wgt_v = r.get("weight")
        bufs["off"][fill] = 0.0 if off_v is None else float(off_v)
        w = 1.0 if wgt_v is None else float(wgt_v)
        bufs["wgt"][fill] = w
        for t in re_types:
            rid = record_entity_id(r, t)
            code = entity_indexes[t].code_of.get(rid, -1)
            if code < 0 and strict_ids:
                raise ValueError(
                    f"entity id {rid!r} of type {t!r} missing from the scan-pass index "
                    "(inputs changed between passes?)"
                )
            bufs[f"code__{t}"][fill] = code
        for cfg in shard_configs:
            imap = index_maps[cfg.shard_id]
            s = 0
            ix_row = bufs[f"ix__{cfg.shard_id}"][fill]
            v_row = bufs[f"v__{cfg.shard_id}"][fill]
            for bag in cfg.feature_bags:
                for f in r.get(bag) or []:
                    j = imap.get_index(feature_key(f["name"], f["term"]))
                    if j >= 0:
                        ix_row[s] = j
                        v_row[s] = float(f["value"])
                        s += 1
            if icepts[cfg.shard_id] >= 0:
                ix_row[s] = icepts[cfg.shard_id]
                v_row[s] = 1.0
        if res is not None and w > 0:
            # sequential algorithm R over the real rows
            seen_real += 1
            if seen_real <= K:
                slot = seen_real - 1
            else:
                slot = int(rng.integers(0, seen_real))
                slot = slot if slot < K else -1
            if slot >= 0:
                for f in res:
                    res[f][slot] = bufs[f][fill]
        fill += 1
        if fill == R:
            store.append(bufs, real_rows=R)
            bufs = new_bufs()
            fill = 0
    if fill:
        store.append(bufs, real_rows=fill)
    store.mark_staged()
    store.finalize()
    if res is not None:
        k_eff = min(seen_real, K)
        res = {k: a[:k_eff] for k, a in res.items()}
    return store, res


# ---------------------------------------------------------------------------
# spilled random-effect grouping
# ---------------------------------------------------------------------------


@dataclass
class _REBucketSegment:
    """One disk-backed slice of a capacity class: at most ``max_entities``
    consecutive entity codes sharing sample capacity S."""

    entity_codes: np.ndarray  # int32 [E_seg], ascending
    capacity: int
    dir: str

    def arrays(self, k: int, mode: str = "r+") -> Dict[str, np.ndarray]:
        E, S = len(self.entity_codes), self.capacity
        shapes = {
            "rows": ((E, S), np.int32),
            "ix": ((E, S, k), np.int32),
            "v": ((E, S, k), np.float32),
            "lab": ((E, S), np.float32),
            "off": ((E, S), np.float32),
            "wgt": ((E, S), np.float32),
        }
        return {
            f: np.memmap(os.path.join(self.dir, f + ".bin"), dtype=dt, mode=mode, shape=shp)
            for f, (shp, dt) in shapes.items()
        }


class SpilledREBuckets:
    """Per-entity grouped active data of ONE random-effect coordinate,
    spilled to disk in budget-bounded segments.

    The in-memory builder's groupByKey (stable sort + flat scatter,
    ``random_effect_data.py``) becomes a direct scatter into disk-backed
    [E_seg, S, k] blocks: the scan's entity counts fix each entity's
    (segment, slot), and one pass over the staged chunks writes every
    sample into place. Entities ascend by code within a capacity class and
    rows fill by ascending global row id, so a segment holds bit for bit
    the in-memory bucket's rows. ``segment_budget_bytes`` caps the bytes a
    segment materializes when solved (at least one entity a segment).

    On a persistent store a completed fill pass is recorded in the
    manifest (keyed by RE type and shard): a restarted run reopens the
    segments and skips it; an interrupted fill runs again from the staged
    chunks (every write lands the same value)."""

    def __init__(
        self,
        store: GameChunkStore,
        re_type: str,
        shard_id: str,
        counts: np.ndarray,
        *,
        segment_budget_bytes: int = 1 << 30,
    ):
        self.store = store
        self.re_type = re_type
        self.shard_id = shard_id
        self.k = store.shard_nnz[shard_id]
        self.num_entities = len(counts)
        E = self.num_entities
        caps = np.zeros(E, np.int64)
        nz = counts > 0
        caps[nz] = 1 << np.ceil(np.log2(np.maximum(counts[nz], 1))).astype(np.int64)
        self.num_active_rows = int(counts.sum())
        fill_tag = f"re__{re_type}__{shard_id}"
        resume = store.fill_done(fill_tag)
        seg_of = np.full(E, -1, np.int64)
        slot_of = np.zeros(E, np.int64)
        self.segments: List[_REBucketSegment] = []

        def per_entity(S):
            return S * (self.k * 8 + 16)

        for S in sorted(set(caps[nz].tolist())):
            members = np.nonzero(caps == S)[0]
            max_e = max(1, int(segment_budget_bytes // per_entity(int(S))))
            for lo in range(0, len(members), max_e):
                seg_members = members[lo:lo + max_e]
                seg_dir = os.path.join(
                    store.dir, f"re__{re_type}__{shard_id}__seg{len(self.segments)}"
                )
                os.makedirs(seg_dir, exist_ok=True)
                seg = _REBucketSegment(seg_members.astype(np.int32), int(S), seg_dir)
                if not resume:
                    arrs = seg.arrays(self.k, mode="w+")
                    arrs["rows"][:] = -1  # memmaps start at 0; rows pad -1
                    for a in arrs.values():
                        a.flush()
                seg_of[seg_members] = len(self.segments)
                slot_of[seg_members] = np.arange(len(seg_members))
                self.segments.append(seg)
        self._seg_of, self._slot_of = seg_of, slot_of
        if not resume:
            self._fill_pass()
            store.mark_fill_done(fill_tag)

    def _fill_pass(self) -> None:
        """Scatter every valid staged row into its entity's (segment,
        slot, rank), one chunk resident at a time."""
        st = self.store
        fill = np.zeros(self.num_entities, np.int64)
        handles = [seg.arrays(self.k) for seg in self.segments]
        for ci in range(st.count):
            c = st.chunk(ci)
            codes = c[f"code__{self.re_type}"]
            rows = np.nonzero((codes >= 0) & (c["wgt"] > 0))[0]
            if not len(rows):
                continue
            e = codes[rows].astype(np.int64)
            # the occurrence rank of each row within its entity in this
            # chunk (rows ascend: fill order is ascending global row id)
            order = np.argsort(e, kind="stable")
            e_s = e[order]
            first = np.searchsorted(e_s, e_s, side="left")
            occ = np.empty(len(rows), np.int64)
            occ[order] = np.arange(len(rows)) - first
            rank = fill[e] + occ
            np.add.at(fill, e, 1)
            gids = (ci * st.R + rows).astype(np.int32)
            ix = c[f"ix__{self.shard_id}"][rows]
            v = c[f"v__{self.shard_id}"][rows]

            def _scatter(c=c, e=e, rank=rank, gids=gids, ix=ix, v=v, rows=rows):
                # behind spill_write: a retried attempt rewrites the same
                # values in place
                for si in np.unique(self._seg_of[e]):
                    m = self._seg_of[e] == si
                    sl = self._slot_of[e[m]]
                    rk = rank[m]
                    h = handles[si]
                    h["rows"][sl, rk] = gids[m]
                    h["ix"][sl, rk] = ix[m]
                    h["v"][sl, rk] = v[m]
                    h["lab"][sl, rk] = c["lab"][rows[m]]
                    h["off"][sl, rk] = c["off"][rows[m]]
                    h["wgt"][sl, rk] = c["wgt"][rows[m]]

            io_call("spill_write", _scatter,
                    detail=f"re__{self.re_type}__{self.shard_id} fill[{ci}]")
        for h in handles:
            for a in h.values():
                a.flush()

    def iter_segments(self):
        """(entity codes, MATERIALIZED arrays) per segment, one resident
        at a time, behind the ``spill_read`` seam."""
        for seg in self.segments:
            arrs = io_call(
                "spill_read",
                lambda seg=seg: {f: np.array(a) for f, a in seg.arrays(self.k).items()},
                detail=seg.dir,
            )
            yield seg.entity_codes, arrs


# ---------------------------------------------------------------------------
# streaming coordinates
# ---------------------------------------------------------------------------


def _chunk_loss(loss, z: Tensor, lab: Tensor, w: Tensor) -> Tensor:
    """The weighted pointwise loss of one chunk."""
    return (w * loss.value(z, lab)).sum()


class _StoreChunkObjective:
    """The streamed objective's contract over one shard's staged chunks,
    with the residual folded into the offsets chunk by chunk (the FE
    coordinate's addScoresToOffsets, read from disk): the scatter partial
    per chunk on ``device``, as the reference keeps it."""

    def __init__(self, store: GameChunkStore, shard_id: str, dim: int, loss, device):
        self.store = store
        self.shard_id = shard_id
        self.dim = dim
        self.device = device
        self._objective = GLMObjective(loss, dim)
        self.residual: Optional[ScoreStore] = None

    def _batches(self):
        st = self.store
        dev = self.device
        for i in range(st.count):
            c = st.chunk(i)
            off = c["off"]
            if self.residual is not None:
                off = off + self.residual.get_chunk(i)
            yield SparseBatch(
                indices=torch.from_numpy(c[f"ix__{self.shard_id}"]).to(dev),
                values=torch.from_numpy(c[f"v__{self.shard_id}"]).to(dev),
                labels=torch.from_numpy(c["lab"]).to(dev),
                offsets=torch.from_numpy(off).to(dev),
                weights=torch.from_numpy(c["wgt"]).to(dev),
            )

    def value_and_gradient(self, w, l2_weight=0.0):
        value = w.new_zeros(())
        grad = w.new_zeros(self.dim)
        for b in self._batches():
            v, g = partial_value_and_gradient(self._objective, w, b)
            value, grad = value + v, grad + g
        value = value + 0.5 * l2_weight * torch.dot(w, w)
        return value, grad + l2_weight * w

    def hessian_vector(self, w, direction, l2_weight=0.0):
        hv = w.new_zeros(self.dim)
        for b in self._batches():
            hv = hv + partial_hessian_vector(self._objective, w, direction, b)
        return hv + l2_weight * direction

    def hessian_diagonal(self, w, l2_weight=0.0):
        diag = w.new_zeros(self.dim)
        for b in self._batches():
            diag = diag + partial_hessian_diagonal(self._objective, w, b)
        return diag + l2_weight


@dataclass
class StreamingFixedEffectCoordinate:
    """FixedEffectCoordinate over the chunk store: the global GLM solve
    walks the host optimizers (one pass over the staged chunks an
    evaluation)."""

    name: str
    store: GameChunkStore
    problem: object  # GLMOptimizationProblem
    feature_shard_id: str
    reg_weight: float = 0.0
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._chunk_obj = _StoreChunkObjective(
            self.store, self.feature_shard_id, self.problem.objective.dim,
            self.problem.objective.loss, self.device,
        )

    @property
    def dim(self) -> int:
        return self.problem.objective.dim

    def initialize_coefficients(self) -> Tensor:
        return torch.zeros(self.dim, device=self.device)

    def update(self, means, residual: Optional[ScoreStore]):
        from photon_ml_tpu_torch.optim.config import OptimizerType
        from photon_ml_tpu_torch.optim.host_lbfgs import minimize_lbfgs_host, minimize_owlqn_host
        from photon_ml_tpu_torch.optim.host_tron import minimize_tron_host
        from photon_ml_tpu_torch.optim.problem import _VARIANCE_EPSILON

        obj = self._chunk_obj
        obj.residual = residual
        p = self.problem
        l1, l2 = p.regularization.split(self.reg_weight)
        w0 = (
            torch.as_tensor(means, device=self.device) if means is not None
            else self.initialize_coefficients()
        )
        cfg = p.config
        try:
            if cfg.optimizer_type == OptimizerType.TRON:
                result = minimize_tron_host(
                    lambda w: obj.value_and_gradient(w, l2),
                    lambda w, d: obj.hessian_vector(w, d, l2),
                    w0, max_iter=cfg.max_iter, tol=cfg.tolerance,
                    max_cg=cfg.tron_max_cg, box=p.box,
                )
            elif l1:
                result = minimize_owlqn_host(
                    lambda w: obj.value_and_gradient(w, l2), w0, l1,
                    max_iter=cfg.max_iter, tol=cfg.tolerance, history=cfg.lbfgs_history,
                    l1_mask=p._l1_mask(self.device), box=p.box,
                )
            else:
                result = minimize_lbfgs_host(
                    lambda w: obj.value_and_gradient(w, l2), w0,
                    max_iter=cfg.max_iter, tol=cfg.tolerance, history=cfg.lbfgs_history,
                    box=p.box,
                )
            variances = None
            if p.compute_variances:
                hd = obj.hessian_diagonal(result.coefficients, l2)
                variances = 1.0 / (hd + _VARIANCE_EPSILON)
        finally:
            obj.residual = None
        return result.coefficients, variances, result

    def score_chunk(self, means, chunk: Dict[str, np.ndarray]) -> Tensor:
        dev = means.device
        ix = torch.from_numpy(chunk[f"ix__{self.feature_shard_id}"]).to(dev).long()
        v = torch.from_numpy(chunk[f"v__{self.feature_shard_id}"]).to(dev)
        return (v * means[ix]).sum(dim=-1)

    def regularization_term(self, means) -> float:
        l1, l2 = self.problem.regularization.split(self.reg_weight)
        term = 0.5 * l2 * torch.dot(means, means)
        if l1:
            term = term + l1 * means.abs().sum()
        # ONE counted fetch for the whole term
        return float(overlap.device_get(term))


@dataclass
class StreamingRandomEffectCoordinate:
    """RandomEffectCoordinate whose per-entity grouping lives on disk:
    each update streams the bucket segments through the in-memory solvers
    (``RandomEffectOptimizationProblem.update_bank``, one single-bucket
    dataset a segment), the residual folded into each segment's offsets
    by a global-row-id gather from the score store. The IDENTITY
    projection is a broadcast view, never materialized. The variance bank
    accumulates over the segments."""

    name: str
    store: GameChunkStore
    spilled: SpilledREBuckets
    problem: object  # RandomEffectOptimizationProblem
    config: RandomEffectDataConfiguration
    local_dim: int = 0  # IDENTITY projector: the shard dimension
    device: DeviceLike = None
    mesh: object = None  # optional 1-D entity mesh (sharded banks)

    def __post_init__(self):
        self._pod = None
        if self.mesh is not None:
            if self.problem.compute_variances:
                raise ValueError(
                    "streaming entity-sharded training does not support "
                    "compute_variances yet; drop --entity-shards or the "
                    "variance flag"
                )
            from photon_ml_tpu_torch.game.pod import PodRandomEffectProblem

            self._pod = PodRandomEffectProblem(self.problem, self.mesh)
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        self._var_bank: Optional[Tensor] = None

    @property
    def num_entities(self) -> int:
        return self.spilled.num_entities

    def _spec(self):
        from photon_ml_tpu_torch.game.pod import EntityShardSpec

        return EntityShardSpec(self._pod.num_shards, self.num_entities)

    def initialize_bank(self):
        if self._pod is not None:
            from photon_ml_tpu_torch.game.pod import ShardedREBank

            return ShardedREBank.zeros(self.mesh, self._spec(), self.local_dim)
        return torch.zeros(self.num_entities, self.local_dim, device=self.device)

    def _mini_dataset(self, codes: np.ndarray, arrays, offsets):
        from photon_ml_tpu_torch.game.random_effect_data import (
            RandomEffectBucket,
            RandomEffectDataset,
        )

        bucket = RandomEffectBucket(
            entity_codes=codes,
            row_index=arrays["rows"],
            indices=arrays["ix"],
            values=arrays["v"],
            labels=arrays["lab"],
            offsets=offsets,
            weights=arrays["wgt"],
        )
        D = self.local_dim
        return RandomEffectDataset(
            config=self.config,
            num_entities=self.num_entities,
            local_dim=D,
            projection=np.broadcast_to(np.arange(D, dtype=np.int32), (self.num_entities, D)),
            row_local_indices=np.zeros((0, 1), np.int32),
            row_local_values=np.zeros((0, 1), np.float32),
            row_entity_codes=np.zeros((0,), np.int32),
            buckets=[bucket],
            num_active_rows=self.spilled.num_active_rows,
            num_passive_rows=0,
            device=self.device,
        )

    def update(self, bank, residual: Optional[ScoreStore]):
        res_flat = residual.flat() if residual is not None else None
        if self._pod is not None:
            return self._update_sharded(bank, res_flat)
        tracker = None
        var_bank = None
        if self.problem.compute_variances:
            var_bank = self._var_bank if self._var_bank is not None else torch.zeros_like(bank)
        for codes, arrays in self.spilled.iter_segments():
            off = arrays["off"]
            if res_flat is not None:
                rows = arrays["rows"]
                off = (off + np.where(rows >= 0, res_flat[np.maximum(rows, 0)], 0.0)).astype(
                    np.float32
                )
            ds = self._mini_dataset(codes, arrays, off)
            if var_bank is not None:
                bank, tracker, seg_vars = self.problem.update_bank(bank, ds, with_variances=True)
                idx = torch.as_tensor(codes, device=bank.device).long()
                var_bank = var_bank.index_copy(0, idx, seg_vars.index_select(0, idx))
            else:
                bank, tracker = self.problem.update_bank(bank, ds)
        if var_bank is not None:
            self._var_bank = var_bank
        return bank, tracker

    def _coerce_sharded(self, bank):
        from photon_ml_tpu_torch.game.pod import ShardedREBank

        if isinstance(bank, ShardedREBank):
            return bank
        # a whole [E, d] bank (checkpoint restore / warm start): shard it
        return ShardedREBank.from_global(self.mesh, self._spec(), bank)

    def _update_sharded(self, bank, res_flat):
        """Pod path: every segment solves as a cross-replica sharded step;
        the residual fold stays a host gather against the on-disk score
        store (the out-of-core contract), the solve and the bank never
        leave their shards."""
        from photon_ml_tpu_torch.game.random_effect_data import RandomEffectBucket

        bank = self._coerce_sharded(bank)
        stat_vecs = []
        for codes, arrays in self.spilled.iter_segments():
            off = arrays["off"]
            if res_flat is not None:
                rows = arrays["rows"]
                off = (off + np.where(rows >= 0, res_flat[np.maximum(rows, 0)], 0.0)).astype(
                    np.float32
                )
            bucket = RandomEffectBucket(
                entity_codes=codes, row_index=arrays["rows"], indices=arrays["ix"],
                values=arrays["v"], labels=arrays["lab"], offsets=off, weights=arrays["wgt"],
            )
            kind = self.problem._bucket_kind(bucket, self.local_dim)
            bank, stat_vec = self._pod.update_segment(bank, codes, arrays, off, kind=kind)
            stat_vecs.append(stat_vec)
        tracker = self._pod.segment_tracker(stat_vecs, self.num_entities) if stat_vecs else None
        return bank, tracker

    @property
    def variances(self) -> Optional[Tensor]:
        return self._var_bank

    def score_chunk(self, bank, chunk: Dict[str, np.ndarray]) -> Tensor:
        sid = self.config.feature_shard_id
        if self._pod is not None:
            codes = chunk[f"code__{self.config.random_effect_type}"]
            return self._pod.score_chunk(
                self._coerce_sharded(bank), codes, chunk[f"ix__{sid}"], chunk[f"v__{sid}"],
                (codes >= 0) & (chunk["wgt"] > 0),
            )
        dev = bank.device
        codes = torch.from_numpy(chunk[f"code__{self.config.random_effect_type}"]).to(dev)
        valid = (codes >= 0) & (torch.from_numpy(chunk["wgt"]).to(dev) > 0)
        ix = torch.from_numpy(chunk[f"ix__{sid}"]).to(dev).long()
        v = torch.from_numpy(chunk[f"v__{sid}"]).to(dev)
        rows = bank.index_select(0, codes.clamp_min(0).long())
        # the pod's score_chunk's order of additions
        score = entity_products.row_dot(v, torch.gather(rows, 1, ix))
        return torch.where(valid, score, 0.0)

    def regularization_term(self, bank) -> float:
        if self._pod is not None:
            return self._pod.regularization_term(self._coerce_sharded(bank))
        return self.problem.regularization_term(bank)


# ---------------------------------------------------------------------------
# streamed coordinate descent
# ---------------------------------------------------------------------------


@dataclass
class StreamingGameResult:
    models: Dict[str, object]  # name -> coefficients / bank
    game_model: object  # GameModel
    objective_history: List[float]
    validation_history: List[Dict[str, float]] = field(default_factory=list)
    best_metric: Optional[float] = None
    trackers: Dict[str, List[object]] = field(default_factory=dict)
    # the run stopped early on a preemption signal; the last completed
    # iteration is checkpointed, so a restarted job resumes
    preempted: bool = False


class StreamingCoordinateDescent:
    """Block coordinate descent over streaming coordinates: the
    CoordinateDescent.run loop (residual = total - own, update, rescore,
    objective) with every [n]-sized quantity on disk per chunk. One
    scratch ScoreStore holds ``total - own`` of the coordinate being
    updated, rebuilt per update from the coordinates' score stores.

    ``checkpointer`` (``reliability.StreamingCDCheckpointer``) snapshots
    every iteration's states, variances and histories; a restarted run
    resumes from the latest and rebuilds the score stores from the
    states. ``preemption_guard`` stops at the next iteration boundary."""

    def __init__(
        self,
        coordinates: Dict[str, object],
        store: GameChunkStore,
        task,
        *,
        update_sequence: Optional[List[str]] = None,
        validation_fn=None,
        validation_metric: Optional[str] = None,
        validation_maximize: bool = True,
        logger: Optional[PhotonLogger] = None,
        checkpointer=None,
        preemption_guard=None,
    ):
        from photon_ml_tpu_torch.ops.losses import loss_for_task

        self.coordinates = coordinates
        self.store = store
        self.task = task
        self.update_sequence = update_sequence or list(coordinates)
        unknown = set(self.update_sequence) - set(coordinates)
        if unknown:
            raise ValueError(f"update sequence references unknown coordinates {unknown}")
        self.validation_fn = validation_fn
        self.validation_metric = validation_metric
        self.validation_maximize = validation_maximize
        self.logger = logger or PhotonLogger()
        self.checkpointer = checkpointer
        self.preemption_guard = preemption_guard
        self._loss = loss_for_task(task)

    def _state(self, name):
        coord = self.coordinates[name]
        if isinstance(coord, StreamingFixedEffectCoordinate):
            return coord.initialize_coefficients()
        return coord.initialize_bank()

    def _preemption_agreed(self) -> bool:
        """Whether to stop for preemption, agreed across processes as
        ``CoordinateDescent._preemption_agreed`` (streamed GAME runs in one
        process, validated up front, so this is the guard's own flag)."""
        if self.preemption_guard is None:
            return False
        from photon_ml_tpu_torch.parallel import multihost

        return multihost.any_process(self.preemption_guard.requested)

    def _rescore(self, name, coord, state, scores) -> None:
        for i in range(self.store.count):
            scores[name].set_chunk(i, coord.score_chunk(state, self.store.chunk(i)))

    def run(self, num_iterations: int) -> StreamingGameResult:
        seq = self.update_sequence
        states = {name: self._state(name) for name in seq}
        variances: Dict[str, object] = {name: None for name in seq}
        scores = {name: self.store.score_store(name) for name in seq}
        residual = self.store.score_store("__residual__") if len(seq) > 1 else None
        objective_history: List[float] = []
        validation_history: List[Dict[str, float]] = []
        trackers: Dict[str, List[object]] = {name: [] for name in seq}
        best_metric = None
        preempted = False
        start_iteration = 0
        if self.checkpointer is not None:
            latest = self.checkpointer.latest_step()
            if latest is not None:
                st, var, hist = self.checkpointer.load(latest)
                for name in seq:
                    coord = self.coordinates[name]
                    dev = coord.device
                    states[name] = torch.as_tensor(st[name], device=dev)
                    v = var.get(name)
                    variances[name] = torch.as_tensor(v, device=dev) if v is not None else None
                    if isinstance(coord, StreamingRandomEffectCoordinate):
                        # later iterations patch the restored variances
                        coord._var_bank = variances[name]
                objective_history = list(hist.get("objective") or [])
                validation_history = list(hist.get("validation") or [])
                best_metric = hist.get("best_metric")
                start_iteration = latest
                # the scores from the restored states: score_chunk is
                # deterministic, so they are the interrupted run's
                for name in seq:
                    self._rescore(name, self.coordinates[name], states[name], scores)
                self.logger.info(
                    "resumed streaming coordinate descent from checkpoint step %d", latest
                )
        for it in range(start_iteration, num_iterations):
            for name in seq:
                coord = self.coordinates[name]
                if residual is not None:
                    for i in range(self.store.count):
                        acc = np.zeros(self.store.R, np.float32)
                        for other in seq:
                            if other != name:
                                acc += scores[other].get_chunk(i)
                        residual.set_chunk(i, acc)
                if isinstance(coord, StreamingFixedEffectCoordinate):
                    means, var, tracker = coord.update(states[name], residual)
                    states[name] = means
                    variances[name] = var
                else:
                    states[name], tracker = coord.update(states[name], residual)
                    variances[name] = coord.variances
                trackers[name].append(tracker)
                self._rescore(name, coord, states[name], scores)
            objective = 0.0
            for i in range(self.store.count):
                c = self.store.chunk(i)
                z = c["off"].astype(np.float64)
                for name in seq:
                    z = z + np.asarray(scores[name].get_chunk(i), np.float64)
                objective += float(_chunk_loss(
                    self._loss, torch.from_numpy(z.astype(np.float32)),
                    torch.from_numpy(c["lab"]), torch.from_numpy(c["wgt"]),
                ))
            for name in seq:
                objective += self.coordinates[name].regularization_term(states[name])
            objective_history.append(objective)
            self.logger.info("streaming coordinate descent iter %d: objective=%g", it + 1, objective)
            if self.validation_fn is not None:
                metrics = self.validation_fn(self.coordinates, states)
                validation_history.append(metrics)
                self.logger.info("iter %d validation: %s", it + 1, metrics)
                if self.validation_metric is not None:
                    m = metrics[self.validation_metric]
                    if (
                        best_metric is None
                        or (self.validation_maximize and m > best_metric)
                        or (not self.validation_maximize and m < best_metric)
                    ):
                        best_metric = m
            if self.checkpointer is not None:
                # iteration it + 1 is a complete resume point
                self.checkpointer.save(
                    it + 1,
                    {name: _host(states[name]) for name in seq},
                    {name: _host(variances[name]) if variances[name] is not None else None
                     for name in seq},
                    {"objective": objective_history, "validation": validation_history,
                     "best_metric": best_metric},
                )
            if self._preemption_agreed():
                preempted = True
                self.logger.warning(
                    "preemption requested: stopping after iteration %d/%d", it + 1, num_iterations
                )
                break
        return StreamingGameResult(
            models=dict(states),
            game_model=self._export_model(states, variances),
            objective_history=objective_history,
            validation_history=validation_history,
            best_metric=best_metric,
            trackers=trackers,
            preempted=preempted,
        )

    @staticmethod
    def score_states_chunk(coordinates, states, chunk) -> np.ndarray:
        """Total model score of one (training or validation) chunk."""
        total = np.zeros(len(chunk["lab"]), np.float32)
        for name, coord in coordinates.items():
            total = total + _host(coord.score_chunk(states[name], chunk)).astype(np.float32)
        return total

    def _export_model(self, states, variances):
        """States -> a GameModel of the standard model classes, so the
        model files and the scoring driver take a streamed fit as they
        are."""
        from photon_ml_tpu_torch.game.model import FixedEffectModel, GameModel, RandomEffectModel
        from photon_ml_tpu_torch.models.coefficients import Coefficients

        models = {}
        for name, coord in self.coordinates.items():
            if isinstance(coord, StreamingFixedEffectCoordinate):
                models[name] = FixedEffectModel(
                    coord.problem.create_model(Coefficients(states[name], variances.get(name))),
                    coord.feature_shard_id,
                )
            else:
                empty = {
                    "rows": np.full((0, 1), -1, np.int32),
                    "ix": np.zeros((0, 1, 1), np.int32),
                    "v": np.zeros((0, 1, 1), np.float32),
                    "lab": np.zeros((0, 1), np.float32),
                    "wgt": np.zeros((0, 1), np.float32),
                }
                state = states[name]
                if hasattr(state, "to_global"):
                    # the model files are whole by definition: one gather
                    state = state.to_global()
                models[name] = RandomEffectModel(
                    state,
                    coord._mini_dataset(np.zeros(0, np.int32), empty, np.zeros((0, 1), np.float32)),
                    coord.config.random_effect_type,
                    coord.config.feature_shard_id,
                    variances=variances.get(name),
                )
        return GameModel(models, self.task)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# end-to-end streamed GAME training
# ---------------------------------------------------------------------------


def validate_streaming_game_configs(
    re_data_configs: Mapping[str, RandomEffectDataConfiguration],
) -> None:
    """The streaming scope gates, with the reference's messages."""
    for name, cfg in re_data_configs.items():
        if cfg.projector_type != ProjectorType.IDENTITY:
            raise ValueError(
                "streaming GAME training supports the IDENTITY projector only "
                f"(coordinate {name!r} uses {cfg.projector_type}); INDEX_MAP/RANDOM "
                "projections need a per-entity re-index pass over the grouped data"
            )
        if cfg.active_data_upper_bound is not None:
            raise ValueError(
                "streaming GAME training does not support active-data-upper-bound "
                f"(coordinate {name!r}): the reservoir cap's without-replacement draw "
                "needs a second grouped pass"
            )


def train_streaming_game(
    paths,
    shard_configs: Sequence[FeatureShardConfiguration],
    fe_data_configs: Mapping[str, FixedEffectDataConfiguration],
    re_data_configs: Mapping[str, RandomEffectDataConfiguration],
    opt_combo: Mapping[str, object],  # name -> GLMOptimizationConfiguration
    task,
    *,
    num_iterations: int = 1,
    update_sequence: Optional[List[str]] = None,
    memory_budget_bytes: int = 0,
    spill_dir: Optional[str] = None,
    index_maps: Optional[Mapping[str, IndexMap]] = None,
    validate_paths=None,
    evaluator_types=None,
    compute_variance: bool = False,
    diagnostic_reservoir_rows: int = 0,
    diagnostic_reservoir_bytes: int = 256 << 20,
    logger: Optional[PhotonLogger] = None,
    checkpoint_dir: Optional[str] = None,
    preemption_guard=None,
    entity_mesh=None,
    device: DeviceLike = None,
):
    """Scan -> stage -> streamed CD [-> streamed validation] on ``device``.
    -> (StreamingGameResult, extras: index maps, entity indexes, stats,
    stores, rows per chunk and the diagnostics sample).

    ``memory_budget_bytes`` (``--stream-memory-budget``) fixes the staged
    chunk's rows and the RE segment byte cap; 0 keeps 65,536-row chunks
    and 1 GiB segments. ``checkpoint_dir``: crash-safe resume of the
    whole pipeline (persistent stage stores, the RE fill flags, one CD
    snapshot an iteration); a restarted run with the same arguments gives
    a bitwise-identical final model. ``entity_mesh`` (this rank's 1-D
    ``entity`` mesh, ``parallel.mesh.entity_mesh``): every random-effect
    bank lives sharded over its ranks by entity hash, each rank staging
    and solving only its own shard of each segment; every rank calls with
    the same arguments (its own ``spill_dir``) and gets the same model."""
    if entity_mesh is not None:
        device = entity_mesh.device
    dev = resolve_device(device)
    logger = logger or PhotonLogger()
    validate_streaming_game_configs(re_data_configs)
    stage_train_dir = stage_validate_dir = cd_dir = None
    if checkpoint_dir is not None:
        ensure_run_manifest(
            os.path.abspath(checkpoint_dir),
            {
                "paths": [str(p) for p in paths],
                "shards": [repr(s) for s in shard_configs],
                "fe": {k: repr(v) for k, v in sorted(fe_data_configs.items())},
                "re": {k: repr(v) for k, v in sorted(re_data_configs.items())},
                "combo": {
                    k: getattr(v, "render", lambda v=v: repr(v))()
                    for k, v in sorted(opt_combo.items())
                },
                "task": getattr(task, "name", str(task)),
                "num_iterations": int(num_iterations),
                "update_sequence": list(update_sequence or []),
                "memory_budget_bytes": int(memory_budget_bytes),
                "validate_paths": [str(p) for p in (validate_paths or [])],
            },
            kind="game-streaming-run",
        )
        stage_train_dir = os.path.join(checkpoint_dir, "stage-train")
        if validate_paths:
            stage_validate_dir = os.path.join(checkpoint_dir, "stage-validate")
        cd_dir = os.path.join(checkpoint_dir, "cd")
    re_types = sorted({c.random_effect_type for c in re_data_configs.values()})
    imaps, entity_indexes, stats = scan_game_stream(
        paths, shard_configs, re_types, index_maps=index_maps
    )
    row_bytes = game_row_bytes(stats.shard_nnz, len(re_types))
    rows_per_chunk = stream_budget_rows(memory_budget_bytes, row_bytes, default_rows=65536)
    rows_per_chunk = int(min(rows_per_chunk, max(stats.num_rows, 8)))
    seg_budget = memory_budget_bytes if memory_budget_bytes > 0 else (1 << 30)
    logger.info(
        "streaming GAME: %d rows, %d B/row -> %d rows/chunk, %d B RE-segment budget",
        stats.num_rows, row_bytes, rows_per_chunk, seg_budget,
    )
    reservoir_rows = 0
    if diagnostic_reservoir_rows > 0:
        reservoir_rows = budgeted_rows(
            diagnostic_reservoir_rows, diagnostic_reservoir_bytes, row_bytes
        )
        if reservoir_rows < diagnostic_reservoir_rows:
            logger.info(
                "GAME diagnostics reservoir scaled to %d rows (%d B budget at %d B/row)",
                reservoir_rows, diagnostic_reservoir_bytes, row_bytes,
            )
    store, sample = stage_game_stream(
        paths, shard_configs, re_types, imaps, entity_indexes, stats,
        rows_per_chunk=rows_per_chunk, spill_dir=spill_dir,
        reservoir_rows=reservoir_rows, persist_dir=stage_train_dir,
    )
    from photon_ml_tpu_torch.game.random_effect import RandomEffectOptimizationProblem
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.optim.problem import create_glm_problem

    loss = loss_for_task(task)
    coordinates: Dict[str, object] = {}
    for name, dcfg in fe_data_configs.items():
        ocfg = opt_combo[name]
        imap = imaps[dcfg.feature_shard_id]
        icept = imap.get_index(intercept_key())
        coordinates[name] = StreamingFixedEffectCoordinate(
            name=name,
            store=store,
            problem=create_glm_problem(
                task, imap.size, config=ocfg.optimizer_config,
                regularization=ocfg.regularization, compute_variances=compute_variance,
                intercept_index=icept if icept >= 0 else None,
            ),
            feature_shard_id=dcfg.feature_shard_id,
            reg_weight=ocfg.reg_weight,
            device=dev,
        )
    for name, dcfg in re_data_configs.items():
        ocfg = opt_combo[name]
        spilled = SpilledREBuckets(
            store, dcfg.random_effect_type, dcfg.feature_shard_id,
            stats.entity_counts[dcfg.random_effect_type], segment_budget_bytes=seg_budget,
        )
        coordinates[name] = StreamingRandomEffectCoordinate(
            name=name,
            store=store,
            spilled=spilled,
            problem=RandomEffectOptimizationProblem(
                loss, ocfg.optimizer_config, ocfg.regularization,
                reg_weight=ocfg.reg_weight, compute_variances=compute_variance,
            ),
            config=dcfg,
            local_dim=imaps[dcfg.feature_shard_id].size,
            device=dev,
            mesh=entity_mesh,
        )

    validation_fn = None
    metric_name = None
    vstore = None
    maximize = True
    if validate_paths:
        vstore, _ = stage_game_stream(
            validate_paths, shard_configs, re_types, imaps, entity_indexes, stats,
            rows_per_chunk=rows_per_chunk, spill_dir=spill_dir, strict_ids=False,
            persist_dir=stage_validate_dir,
        )
        validation_fn, metric_name, maximize = streamed_validation(
            vstore, task, loss, evaluator_types
        )
    cd_checkpointer = None
    if cd_dir is not None:
        from photon_ml_tpu_torch.reliability.checkpoint import StreamingCDCheckpointer

        cd_checkpointer = StreamingCDCheckpointer(cd_dir)
    cd = StreamingCoordinateDescent(
        coordinates, store, task,
        update_sequence=update_sequence,
        validation_fn=validation_fn,
        validation_metric=metric_name,
        validation_maximize=maximize,
        logger=logger,
        checkpointer=cd_checkpointer,
        preemption_guard=preemption_guard,
    )
    result = cd.run(num_iterations)
    extras = dict(
        index_maps=imaps,
        entity_indexes=entity_indexes,
        stats=stats,
        store=store,
        validate_store=vstore,
        rows_per_chunk=rows_per_chunk,
        diagnostics_sample=sample,
    )
    return result, extras


def streamed_validation(vstore: GameChunkStore, task, loss, evaluator_types=None):
    """-> (validation_fn(coordinates, states) -> metrics, the first
    metric's name, whether it is maximized): one pass over the staged
    validation chunks per call, through the streaming accumulators."""
    from photon_ml_tpu_torch.evaluation.evaluator import _LOSS_BY_NAME, EvaluatorType
    from photon_ml_tpu_torch.evaluation.streaming import (
        StreamingAUC,
        StreamingMeanLoss,
        StreamingRMSE,
    )
    from photon_ml_tpu_torch.task import TaskType

    evaluators = evaluator_types or [
        EvaluatorType.parse("AUC" if task == TaskType.LOGISTIC_REGRESSION else "RMSE")
    ]
    for et in evaluators:
        if et.is_sharded:
            raise ValueError(
                f"streamed GAME validation does not support the sharded evaluator "
                f"{et.render()} (per-group metrics need a grouped pass over the "
                "validation stream)"
            )

    def validation_fn(coords, states):
        accs = {}
        for et in evaluators:
            key = et.render()
            if et.name == "AUC":
                accs[key] = ("margin", StreamingAUC())
            elif et.name == "RMSE":
                accs[key] = ("mean", StreamingRMSE())
            else:
                accs[key] = ("margin", StreamingMeanLoss(_LOSS_BY_NAME[et.name]))
        for i in range(vstore.count):
            c = vstore.chunk(i)
            z = StreamingCoordinateDescent.score_states_chunk(coords, states, c) + c["off"]
            for space, acc in accs.values():
                if space == "mean":
                    vals = loss.mean(torch.from_numpy(z))
                else:
                    vals = torch.from_numpy(z)
                acc.update(vals, torch.from_numpy(c["lab"]), torch.from_numpy(c["wgt"]))
        return {key: acc.result() for key, (_, acc) in accs.items()}

    return validation_fn, evaluators[0].render(), evaluators[0].maximize
