"""Streaming (larger than host RAM) GLM input: chunked decode into
fixed-shape batches on the device, cache tiers, and the streamed objective
(port of ``photon_ml_tpu/io/streaming.py``, single process).

Reference: the reference streams Avro partitions lazily into RDD rows
(io/GLMSuite.scala:98-131) and relies on Spark's MEMORY_AND_DISK persist.
Here every optimizer evaluation folds fixed-shape ``[R, W]`` chunks, so
peak host memory is one decoded file + one staged chunk whatever the
dataset's size. The first evaluation fills the cache tiers: chunks on the
device up to ``cache_bytes``, the rest spilled as raw arrays to local
scratch; later evaluations read the tiers and never decode again. Once the
tiers exist, each chunk's K1 schedules are built once and kept on the card
up to ``tiled_cache_bytes``: every later evaluation runs K1 chunk by chunk
and accumulates on the device, with no host fetch per chunk.

Threads: a worker thread only decodes and stages host arrays
(:func:`_prefetched`); every upload happens on the consumer's thread, from
pinned memory with ``non_blocking=True``, so it queues on the consumer's
stream in order with the kernels that read it.

Several processes (``parallel/multihost.py``): each streams its shard of
the input files (:func:`shard_stream_files`, split by content so every
process agrees), and every evaluation's partials, like the summary's
moments, are gathered and summed in rank order, so each process holds the
same bits run after run. :class:`FeatureShardedStreamingObjective` streams
every file on each rank of a (data, model) mesh and keeps only the rank's
cell of each chunk: the reference's single process over a mesh of
devices, with ranks for devices.
"""

from __future__ import annotations

import itertools
import os
import queue
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.data.stats import finalize_summary, sparse_moments
from photon_ml_tpu_torch.ops.objective import (
    partial_hessian_diagonal,
    partial_hessian_vector,
    partial_value_and_gradient,
)
from photon_ml_tpu_torch.reliability.faults import inject
from photon_ml_tpu_torch.reliability.retry import io_call
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

# Decode passes over input files made by iter_chunks (the scans are
# counted apart, by the callers of scan_stream); a run sets it to 0 and
# reads it.
decode_passes = 0


@dataclass(frozen=True)
class StreamStats:
    """One-pass scan results that fix the staging-batch shape."""

    num_rows: int
    max_nnz: int  # per-row nonzeros INCLUDING the intercept slot


def scan_stream(paths, fmt, *, index_map=None):
    """One bounded-memory pass through ``fmt.stream_scan``: the vocabulary
    (skipped with a prebuilt ``index_map``), the row count and the max
    per-row nnz. -> (index_map, StreamStats)."""
    return fmt.stream_scan(paths, index_map=index_map)


def scan_stream_with_summary(paths, fmt, *, index_map=None, device: DeviceLike = None):
    """Fused scan: ONE pass for the vocabulary, the shape stats AND the
    colStats summary; formats without the fused hook (LibSVM) take two
    passes (scan, then :func:`streaming_summary`). -> (index_map,
    StreamStats, summary)."""
    fused = getattr(fmt, "stream_scan_with_summary", None)
    if fused is not None:
        return fused(paths, index_map=index_map, device=device)
    index_map, stats = scan_stream(paths, fmt, index_map=index_map)
    summary, _ = streaming_summary(paths, fmt, index_map, stats, device=device)
    return index_map, stats, summary


def _file_rows(fmt, path, index_map):
    """One file's rows for a format without the block hook (LibSVM, one
    line at a time), behind the ``chunk_read`` seam: it covers the
    stream's construction; a mid-file read error propagates."""
    return io_call("chunk_read", fmt.stream_rows, path, index_map, detail=path)


class RowBlock(NamedTuple):
    """Rows as padded arrays: indices [m, w], values [m, w] (float64, as
    decoded), each row's entry count ``lens`` [m] (entries past it are 0)
    and labels / offsets / weights [m]."""

    ix: np.ndarray
    v: np.ndarray
    lens: np.ndarray
    lab: np.ndarray
    off: np.ndarray
    wgt: np.ndarray


def rows_to_block(rows) -> RowBlock:
    """(indices, values, label, offset, weight) rows -> one RowBlock."""
    rows = list(rows)
    m = len(rows)
    lens = np.asarray([len(r[0]) for r in rows], np.int64)
    w = max(int(lens.max()) if m else 0, 1)
    ix = np.zeros((m, w), np.int64)
    v = np.zeros((m, w), np.float64)
    for i, (r_ix, r_v, *_rest) in enumerate(rows):
        ix[i, : len(r_ix)] = r_ix
        v[i, : len(r_v)] = r_v
    scalars = np.asarray([r[2:] for r in rows], np.float64).reshape(m, 3)
    return RowBlock(ix, v, lens, *scalars.T)


def _row_blocks(files, fmt, index_map, pipeline: bool, rows_per_block: int = 4096):
    """The stream's rows as RowBlocks: one a file through the format's
    block hook (Avro: the native decode's vectorized remap), each file's
    whole-file decode the retryable unit behind the ``chunk_read`` seam,
    and with ``pipeline`` decoded on a worker thread one file ahead while
    this thread stages (the reference's ``_pipelined_file_rows``); formats
    without the hook stream rows, packed ``rows_per_block`` at a time."""
    decode = getattr(fmt, "decode_payload", None)
    block_from = getattr(fmt, "stream_block_from_payload", None)
    if decode is None or block_from is None:
        rows = (row for path in files for row in _file_rows(fmt, path, index_map))
        while True:
            batch = list(itertools.islice(rows, rows_per_block))
            if not batch:
                return
            yield rows_to_block(batch)

    def decoded():
        for path in files:
            yield path, io_call("chunk_read", decode, path, detail=path)

    for path, payload in _prefetched(decoded(), depth=1) if pipeline else decoded():
        yield block_from(payload, path, index_map)


class HostChunk(NamedTuple):
    """One staged chunk as host arrays: indices int32 [R, W], values
    float32 [R, W], labels / offsets / weights float32 [R]."""

    ix: np.ndarray
    v: np.ndarray
    lab: np.ndarray
    off: np.ndarray
    wgt: np.ndarray


def upload(chunk: HostChunk, device: torch.device) -> SparseBatch:
    """A host chunk as a SparseBatch on ``device``, on the calling thread.
    To the card each array goes through a pinned copy with
    ``non_blocking=True`` (the pinned block is not reused before its copy
    ends); on the CPU the arrays are wrapped, and must not be written
    again (every HostChunk here is a fresh copy)."""
    if device.type == "cuda":
        def t(a):
            return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
    else:
        t = torch.from_numpy
    return SparseBatch(
        indices=t(chunk.ix), values=t(chunk.v), labels=t(chunk.lab),
        offsets=t(chunk.off), weights=t(chunk.wgt),
    )


def iter_host_chunks(
    paths, fmt, index_map, *, rows_per_chunk: int, nnz_width: int,
    pipeline: Optional[bool] = None,
) -> Iterator[HostChunk]:
    """Fixed-shape [rows_per_chunk, nnz_width] host chunks of the stream
    (weight-0 padding rows in the last one). ``pipeline``: decode the next
    file on a worker thread while this one stages (None: when the host has
    more than one core). Each chunk is a COPY of the staging buffers,
    which the next rows refill."""
    global decode_passes
    if pipeline is None:
        from photon_ml_tpu_torch.parallel.overlap import overlap_enabled

        pipeline = overlap_enabled() and (os.cpu_count() or 1) > 1
    files = fmt.stream_files(paths) if paths else []
    decode_passes += 1
    R, W = rows_per_chunk, nnz_width
    bufs = HostChunk(
        np.zeros((R, W), np.int32), np.zeros((R, W), np.float32),
        np.zeros(R, np.float32), np.zeros(R, np.float32), np.zeros(R, np.float32),
    )
    ix_buf, v_buf, lab_buf, off_buf, wgt_buf = bufs
    fill = 0

    def emit() -> HostChunk:
        # the copies are load-bearing: the buffers are refilled next
        return HostChunk(*(a.copy() for a in bufs))

    for block in _row_blocks(files, fmt, index_map, pipeline):
        m = len(block.lens)
        if not m:
            continue
        longest = int(block.lens.max())
        if longest > W:
            raise ValueError(
                f"row has {longest} nonzeros > staging width {W}; "
                "re-scan the stream or raise nnz_width"
            )
        w = min(block.ix.shape[1], W)  # slots past a row's entries are 0
        a = 0
        while a < m:
            n = min(R - fill, m - a)
            rows, dst = slice(a, a + n), slice(fill, fill + n)
            ix_buf[dst, :w] = block.ix[rows, :w]
            ix_buf[dst, w:] = 0
            v_buf[dst, :w] = block.v[rows, :w]
            v_buf[dst, w:] = 0.0
            lab_buf[dst] = block.lab[rows]
            off_buf[dst] = block.off[rows]
            wgt_buf[dst] = block.wgt[rows]
            fill += n
            a += n
            if fill == R:
                yield emit()
                fill = 0
    if fill:
        for a in bufs:
            a[fill:] = 0  # weight-0 rows are inert in every objective
        yield emit()


def iter_chunks(
    paths, fmt, index_map, *, rows_per_chunk: int, nnz_width: int,
    pipeline: Optional[bool] = None, device: DeviceLike = None,
) -> Iterator[SparseBatch]:
    """:func:`iter_host_chunks` uploaded to ``device``: every chunk has the
    same shape, so one objective serves the whole stream."""
    dev = resolve_device(device)
    for chunk in iter_host_chunks(
        paths, fmt, index_map, rows_per_chunk=rows_per_chunk,
        nnz_width=nnz_width, pipeline=pipeline,
    ):
        yield upload(chunk, dev)


def _prefetched(source: Iterator, depth: int = 2) -> Iterator:
    """Decode-ahead: a worker thread keeps up to ``depth`` items of
    ``source`` queued while the consumer computes. The worker only reads
    and decodes; abandoning the generator stops it (its puts poll a stop
    flag), so no thread leaks across a failed evaluation. A worker error
    is raised on the consumer's side."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    errors: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            # the decode_ahead seam accounts the hand-off to this thread
            inject("decode_ahead")
            for item in source:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            errors.append(e)
        finally:
            _put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()


def shard_stream_files(paths, fmt) -> List[str]:
    """This process's shard of the format's input files: the sorted list
    (``fmt.stream_files``), split by content (``multihost.process_shard``)
    so that every process agrees whatever order it listed them in. The
    whole list single-process."""
    from photon_ml_tpu_torch.parallel.multihost import process_count, process_shard

    if process_count() <= 1:
        return fmt.stream_files(paths)
    return process_shard(fmt.stream_files(paths))


def shard_avro_files(paths) -> List[str]:
    """:func:`shard_stream_files` of the default Avro format."""
    from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat

    return shard_stream_files(paths, AvroInputDataFormat())


def streaming_summary(
    paths, fmt, index_map, stats: StreamStats, *, rows_per_chunk: int = 65536,
    reservoir_rows: int = 0, seed: int = 0, device: DeviceLike = None,
):
    """One bounded-memory pass computing the feature summary (colStats,
    BasicStatistics.scala:42) over the stream, with moments accumulated in
    float64 on ``device``, plus an optional uniform RESERVOIR SAMPLE of
    ``reservoir_rows`` rows (algorithm R, numpy ``default_rng(seed)``
    draws as the reference makes them) for the diagnostics that resample
    rows. -> (summary, sample SparseBatch on ``device`` or None)."""
    dev = resolve_device(device)
    dim = index_map.size
    acc = None
    K = int(reservoir_rows)
    rng = np.random.default_rng(seed)
    W = stats.max_nnz
    res = HostChunk(
        np.zeros((K, W), np.int32), np.zeros((K, W), np.float32),
        np.zeros(K, np.float32), np.zeros(K, np.float32), np.zeros(K, np.float32),
    ) if K else None
    seen = 0
    for host in iter_host_chunks(paths, fmt, index_map, rows_per_chunk=rows_per_chunk, nnz_width=W):
        chunk = upload(host, dev)
        m = sparse_moments(
            SparseBatch(chunk.indices, chunk.values.double(), chunk.labels,
                        chunk.offsets, chunk.weights.double()),
            dim,
        )
        if acc is None:
            acc = [t.double() for t in m]
        else:
            for i in range(5):  # n, s1, s2, l1, nnz are sums
                acc[i] = acc[i] + m[i]
            acc[5] = torch.maximum(acc[5], m[5])
            acc[6] = torch.minimum(acc[6], m[6])
        if res is not None:
            real = np.nonzero(host.wgt > 0)[0]
            n_real = len(real)
            if n_real:
                # vectorized algorithm R (exact): per-row acceptance draws
                # and random slots; numpy fancy assignment applies
                # duplicates in order, so the LAST accepted row wins
                t = seen + 1 + np.arange(n_real)  # global 1-based ranks
                fill_mask = t <= K
                slots = np.where(fill_mask, t - 1, 0)
                u = rng.random(n_real)
                accept = fill_mask | (u < K / t)
                rand_slots = rng.integers(0, K, size=n_real)
                slots = np.where(fill_mask, slots, rand_slots)
                sel = real[accept]
                dst = slots[accept]
                for r, a in zip(res, host):
                    r[dst] = a[sel]
                seen += n_real
    from photon_ml_tpu_torch.parallel import multihost

    if multihost.process_count() > 1:
        # each process scanned its file shard; one with no files joins with
        # inert moments. Sums in rank order, so every process agrees.
        if acc is None:
            big = float("inf")
            z = torch.zeros(dim, dtype=torch.float64, device=dev)
            acc = [z.new_zeros(()), z, z, z, z, z - big, z + big]
        gathered = multihost.allgather_objects([t.cpu() for t in acc])
        acc = [t.to(dev) for t in gathered[0]]
        for other in gathered[1:]:
            other = [t.to(dev) for t in other]
            for i in range(5):
                acc[i] = acc[i] + other[i]
            acc[5] = torch.maximum(acc[5], other[5])
            acc[6] = torch.minimum(acc[6], other[6])
        if float(acc[0]) == 0:
            raise ValueError(f"no rows found under {paths!r} on any process")
    elif acc is None:
        raise ValueError(f"no rows found under {paths!r}")
    summary = finalize_summary(*(t.float() for t in acc))
    sample = None
    if res is not None:
        k_eff = min(seen, K)
        sample = upload(HostChunk(*(a[:k_eff].copy() for a in res)), dev)
    return summary, sample


# Live spill scratch directories, swept at interpreter exit: __del__ alone
# is no cleanup contract (an exception that keeps the objective alive in a
# traceback skips finalizers). Every spill dir registers here at creation
# and unregisters on close(). A hard kill runs no handler: point
# PHOTON_SPILL_DIR at a directory an external sweeper cleans.
_LIVE_SPILL_DIRS: set = set()


def _sweep_spill_dirs() -> None:
    for d in list(_LIVE_SPILL_DIRS):
        _LIVE_SPILL_DIRS.discard(d)
        shutil.rmtree(d, ignore_errors=True)


def register_spill_dir(path: str) -> None:
    """Track a scratch directory for the atexit sweep."""
    import atexit

    if not _LIVE_SPILL_DIRS:
        atexit.register(_sweep_spill_dirs)
    _LIVE_SPILL_DIRS.add(path)


def unregister_spill_dir(path: str) -> None:
    _LIVE_SPILL_DIRS.discard(path)


def make_spill_dir(prefix: str, spill_dir: Optional[str] = None) -> str:
    """Create and register a scratch directory under ``spill_dir``, else
    ``$PHOTON_SPILL_DIR``, else the system temp dir (RAM-backed on hosts
    with a tmpfs /tmp: point PHOTON_SPILL_DIR at a disk for data larger
    than RAM)."""
    base = spill_dir or os.environ.get("PHOTON_SPILL_DIR")
    path = tempfile.mkdtemp(prefix=prefix, dir=base)
    register_spill_dir(path)
    return path


def stream_budget_rows(
    budget_bytes: int, bytes_per_row: int, *, default_rows: int = 65536,
    min_rows: int = 8,
) -> int:
    """Rows per chunk under a host-memory byte budget
    (``--stream-memory-budget``): budget // row bytes, at least
    ``min_rows``; a budget <= 0 keeps ``default_rows``."""
    if budget_bytes is None or budget_bytes <= 0:
        return default_rows
    return max(min_rows, budget_bytes // max(1, bytes_per_row))


def sparse_row_bytes(nnz_width: int) -> int:
    """Staged bytes per row of a sparse chunk: an int32 index and a
    float32 value per slot, plus label, offset and weight."""
    return max(1, nnz_width) * 8 + 12


def budgeted_rows(max_rows: int, budget_bytes: int, bytes_per_row: int) -> int:
    """Rows of a bounded in-memory sample (the diagnostics reservoir)
    under a byte budget: wide rows scale the count down."""
    return max(1, min(max_rows, budget_bytes // max(1, bytes_per_row)))


class _DiskChunkStore:
    """Fixed-shape staged chunks spilled to a scratch directory, the disk
    half of persist(MEMORY_AND_DISK): later evaluations re-read the raw
    arrays (one sequential memmap pass) instead of decoding again."""

    _FIELDS = HostChunk._fields

    def __init__(self, rows_per_chunk: int, nnz_width: int, spill_dir: Optional[str] = None):
        self.R, self.W = rows_per_chunk, nnz_width
        self.dir = make_spill_dir("photon-stream-spill-", spill_dir)
        self.count = 0
        self._writers = {
            f: open(os.path.join(self.dir, f + ".bin"), "wb") for f in self._FIELDS
        }

    @property
    def nbytes(self) -> int:
        return self.count * self.R * (self.W * 8 + 12)

    def append(self, chunk: HostChunk) -> None:
        for f, a in zip(self._FIELDS, chunk):
            data = a.tobytes()
            w = self._writers[f]
            # seek to the chunk's fixed offset per attempt: a retry after
            # a partial write overwrites in place
            off = self.count * len(data)

            def _write(w=w, data=data, off=off):
                w.seek(off)
                w.write(data)

            io_call("spill_write", _write, detail=f"{self.dir}/{f}.bin[{self.count}]")
        self.count += 1

    def finalize(self) -> None:
        for f in self._writers.values():
            f.close()

    def chunks(self, start: int = 0) -> Iterator[HostChunk]:
        """The spilled chunks from chunk ``start`` on."""
        R, W, n = self.R, self.W, self.count
        if n <= start:
            return
        layout = {"ix": (np.int32, (n, R, W)), "v": (np.float32, (n, R, W))}
        mm = {}
        for f in self._FIELDS:
            dtype, shape = layout.get(f, (np.float32, (n, R)))
            mm[f] = np.memmap(
                os.path.join(self.dir, f + ".bin"), dtype=dtype, mode="r", shape=shape
            )
        for i in range(start, n):
            # materializing one chunk from the memmaps is idempotent, so
            # a transient read error retries in place
            yield io_call(
                "spill_read",
                lambda i=i: HostChunk(*(np.array(mm[f][i]) for f in self._FIELDS)),
                detail=f"{self.dir}[{i}]",
            )

    def close(self) -> None:
        self.finalize()
        unregister_spill_dir(self.dir)
        shutil.rmtree(self.dir, ignore_errors=True)

    def __del__(self):  # the scratch must not outlive the objective
        try:
            self.close()
        except Exception:
            pass


class StreamingGLMObjective:
    """The GLM objective's contract (value / gradient / Hv / Hessian
    diagonal of a coefficient vector, ``l2_weight`` added once at the end)
    over a stream of input files; full-batch semantics with bounded host
    memory. Feed it to the host-driven optimizers (``optim/host_lbfgs.py``,
    ``optim/host_tron.py``).

    The first evaluation fills the cache tiers: chunks on ``device`` up to
    ``cache_bytes``, the rest spilled to scratch (``spill_dir``, else
    ``$PHOTON_SPILL_DIR``); ``cache_bytes=0`` decodes on every evaluation.
    ``prefetch`` decodes (and reads the spill) one chunk ahead on a worker
    thread.

    ``kernel``: "auto" (``optim.problem.resolve_kernel``: tiled on the
    card, scatter on the CPU), "tiled" or "scatter". Tiled: once the tiers
    exist, each chunk's z and g schedules are built once (the native
    builder, one chunk's COO alive at a time, through the schedule cache
    of ``tile_cache_dir``) and kept on the device up to
    ``tiled_cache_bytes``; every evaluation then runs K1 once per pass per
    tiled chunk, and the chunks past that budget take the scatter partial.
    ``norm``: the normalization context, applied algebraically as the
    in-memory objectives apply it.
    """

    def __init__(
        self,
        paths,
        fmt,
        index_map,
        stats: StreamStats,
        task,
        *,
        rows_per_chunk: int = 65536,
        cache_bytes: int = 2 << 30,
        prefetch: bool = True,
        spill_dir: Optional[str] = None,
        kernel: str = "auto",
        tiled_cache_bytes: int = 4 << 30,
        tile_params=None,
        norm=None,
        tile_cache_dir: Optional[str] = None,
        device: DeviceLike = None,
    ):
        from photon_ml_tpu_torch.ops.losses import loss_for_task
        from photon_ml_tpu_torch.ops.normalization import identity_context
        from photon_ml_tpu_torch.ops.objective import GLMObjective
        from photon_ml_tpu_torch.ops.tiled_sparse import TiledGLMObjective
        from photon_ml_tpu_torch.optim.problem import resolve_kernel

        self.device = resolve_device(device)
        self.paths = paths
        self.fmt = fmt
        self.index_map = index_map
        self.stats = stats
        self.rows_per_chunk = int(min(rows_per_chunk, max(stats.num_rows, 8)))
        self.nnz_width = stats.max_nnz
        self.dim = index_map.size
        self.cache_bytes = int(cache_bytes)
        self.prefetch = prefetch
        self.spill_dir = spill_dir
        self._mem_cache: List[SparseBatch] = []
        self._disk_cache: Optional[_DiskChunkStore] = None
        self._cached = False
        # passes over the input files that decoded (the fill pass; every
        # pass when cache_bytes is 0)
        self.decode_passes = 0
        loss = loss_for_task(task)
        self.norm = norm if norm is not None else identity_context()
        self._objective = GLMObjective(loss, self.dim, self.norm)
        self._use_tiled = resolve_kernel(kernel, self.device) == "tiled"
        self._tiled_objective = TiledGLMObjective(loss, self.dim, self.norm)
        self.tiled_cache_bytes = int(tiled_cache_bytes)
        self.tile_params = tile_params
        self.tile_cache_dir = tile_cache_dir
        self._tiled: Optional[list] = None  # TiledSparseBatch per kept chunk
        # the schedule bytes each kept chunk counted against the budget
        self.tiled_nbytes: List[int] = []

    # -- cache tiers -----------------------------------------------------

    def _chunk_nbytes(self) -> int:
        return self.rows_per_chunk * sparse_row_bytes(self.nnz_width)

    @property
    def tier_counts(self) -> dict:
        """Chunks in each tier: device, disk, tiled and scatter overflow
        (the last two once the tiled chunks are built)."""
        n_disk = self._disk_cache.count if self._disk_cache is not None else 0
        n_tiled = len(self._tiled) if self._tiled is not None else 0
        total = len(self._mem_cache) + n_disk
        return {
            "device": len(self._mem_cache), "disk": n_disk, "tiled": n_tiled,
            "overflow": total - n_tiled if self._tiled is not None else total,
        }

    @property
    def spill_bytes(self) -> int:
        return self._disk_cache.nbytes if self._disk_cache is not None else 0

    def _host_chunks(self) -> Iterator[HostChunk]:
        self.decode_passes += 1
        source = iter_host_chunks(
            self.paths, self.fmt, self.index_map,
            rows_per_chunk=self.rows_per_chunk, nnz_width=self.nnz_width,
        )
        return _prefetched(source) if self.prefetch else source

    def chunks(self, start: int = 0) -> Iterator[SparseBatch]:
        """Every chunk of the stream on the device, in stream order: from
        the tiers once they exist (from chunk ``start`` on; the chunks
        before it are not read), else decoded (filling the tiers)."""
        dev = self.device
        if self._cached:
            yield from self._mem_cache[start:]
            if self._disk_cache is not None:
                spill = self._disk_cache.chunks(max(0, start - len(self._mem_cache)))
                for host in _prefetched(spill) if self.prefetch else spill:
                    yield upload(host, dev)
            return
        assert start == 0, "the tiers do not exist yet"
        if self.cache_bytes <= 0:
            for host in self._host_chunks():
                yield upload(host, dev)
            return
        budget = max(1, self.cache_bytes // max(1, self._chunk_nbytes()))
        mem: List[SparseBatch] = []
        disk: Optional[_DiskChunkStore] = None
        for host in self._host_chunks():
            batch = upload(host, dev)
            if len(mem) < budget:
                mem.append(batch)
            else:
                if disk is None:
                    disk = _DiskChunkStore(self.rows_per_chunk, self.nnz_width, self.spill_dir)
                disk.append(host)
            yield batch
        if disk is not None:
            disk.finalize()
        self._mem_cache = mem
        self._disk_cache = disk
        self._cached = True

    # -- tiled chunk cache -------------------------------------------------

    def _build_tiled_chunks(self) -> None:
        """Each cached chunk as a TiledSparseBatch on the device, built
        once. The first chunk's entry count resolves the tile parameters
        of all (every chunk has the staging shape), so each chunk's
        schedules are the JAX package's before its padding to one shape,
        and the schedule cache keys match. One chunk's COO is alive at a
        time; chunks past ``tiled_cache_bytes`` stay on the scatter
        partial."""
        from photon_ml_tpu_torch.ops import schedule_cache
        from photon_ml_tpu_torch.ops import tiled_sparse as ts
        from photon_ml_tpu_torch.parallel import multihost

        own = (multihost.process_index(),)
        params0 = self.tile_params or ts.TileParams()
        win = params0.window
        r_pad = ts._whole_windows(self.rows_per_chunk, win)
        d_pad = ts._whole_windows(self.dim, win)
        z_blocks, g_blocks = r_pad // win, d_pad // win
        meta = None
        built = []
        self.tiled_nbytes = []
        budget = self.tiled_cache_bytes
        with schedule_cache.cache_scope(self.tile_cache_dir), ThreadPoolExecutor(2) as pool:
            for batch in self.chunks():
                rows, feats, vals = ts._sparse_coo(batch)
                if meta is None:
                    meta = ts.TiledMeta(
                        params0.resolved(len(vals), z_blocks * g_blocks),
                        r_pad, d_pad, self.rows_per_chunk, self.dim,
                    )
                digest = (
                    schedule_cache.content_digest(rows, feats, vals)
                    if schedule_cache.resolve_cache_dir() is not None else None
                )
                # the chunks of this process's own files: it alone builds them
                kw = dict(params=meta.params, digest=digest, builders=own)
                fz = pool.submit(
                    ts._build_schedule, rows, feats, vals,
                    sort_by_feature_block=False, num_out_blocks=z_blocks, **kw,
                )
                g, g_builder = ts._build_schedule(
                    rows, feats, vals, sort_by_feature_block=True,
                    num_out_blocks=g_blocks, **kw,
                )
                z, z_builder = fz.result()
                del rows, feats, vals
                nbytes = sum(a.nbytes for a in z) + 2 * sum(a.nbytes for a in g)
                if nbytes > budget:
                    break  # the remaining chunks stay on the scatter partial
                budget -= nbytes
                self.tiled_nbytes.append(nbytes)
                built.append(ts.tiled_batch_from_arrays(
                    z, g, g[5] ** 2, *ts._padded_rows(r_pad, *ts._row_arrays(batch)),
                    meta=meta, device=self.device,
                    builder=z_builder if z_builder == g_builder else "mixed",
                ))
        self._tiled = built

    def _ensure_tiled(self) -> bool:
        if not (self._use_tiled and self._cached):
            return False
        if self._tiled is None:
            self._build_tiled_chunks()
        return len(self._tiled) > 0

    def _passes(self):
        """(tiled chunks, scatter chunks) of one evaluation."""
        if self._ensure_tiled():
            return self._tiled, self.chunks(len(self._tiled))
        return (), self.chunks()

    # -- the objective -----------------------------------------------------

    @staticmethod
    def _reduce_hosts(vec: torch.Tensor) -> torch.Tensor:
        """The processes' partials summed in rank order (the
        treeAggregate's combine); ``vec`` single-process."""
        from photon_ml_tpu_torch.parallel.multihost import sum_in_rank_order

        return sum_in_rank_order(vec)

    def value_and_gradient(self, w, l2_weight=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        value = w.new_zeros(())
        grad = w.new_zeros(self.dim)
        tiled, scattered = self._passes()
        for tb in tiled:
            v, g = self._tiled_objective.value_and_gradient(w, tb, 0.0)
            value, grad = value + v, grad + g
        for batch in scattered:
            v, g = partial_value_and_gradient(self._objective, w, batch)
            value, grad = value + v, grad + g
        packed = self._reduce_hosts(torch.cat([value[None], grad]))
        value, grad = packed[0], packed[1:]
        value = value + 0.5 * l2_weight * torch.dot(w, w)
        return value, grad + l2_weight * w

    def hessian_vector(self, w, direction, l2_weight=0.0) -> torch.Tensor:
        """Streamed H(w) @ d: one pass over the tiers per CG step
        (HessianVectorAggregator.scala:137-152)."""
        hv = w.new_zeros(self.dim)
        tiled, scattered = self._passes()
        for tb in tiled:
            hv = hv + self._tiled_objective.hessian_vector(w, direction, tb, 0.0)
        for batch in scattered:
            hv = hv + partial_hessian_vector(self._objective, w, direction, batch)
        return self._reduce_hosts(hv) + l2_weight * direction

    def hessian_diagonal(self, w, l2_weight=0.0) -> torch.Tensor:
        """Streamed Hessian diagonal (the variance pass)."""
        diag = w.new_zeros(self.dim)
        tiled, scattered = self._passes()
        for tb in tiled:
            diag = diag + self._tiled_objective.hessian_diagonal(w, tb, 0.0)
        for batch in scattered:
            diag = diag + partial_hessian_diagonal(self._objective, w, batch)
        return self._reduce_hosts(diag) + l2_weight

    def close(self) -> None:
        """Drop the tiers and remove the spill directory."""
        if self._disk_cache is not None:
            self._disk_cache.close()
        self._disk_cache = None
        self._mem_cache = []
        self._tiled = None
        self._cached = False


class FeatureShardedStreamingObjective:
    """The streamed objective over a FEATURE-SHARDED coefficient vector on
    a (data, model) mesh of ranks: a dataset larger than host memory and a
    model larger than one card at once (the reference's
    ``FeatureShardedStreamingObjective``, with ranks for its devices).

    Every rank streams all the files through the staged-chunk tiers of a
    :class:`StreamingGLMObjective` (the scatter kernel: the cells below do
    the math) and cuts each chunk to its (data shard x feature block) cell
    (``parallel.distributed.feature_shard_sparse_batch``), built once and
    kept on the device up to ``sharded_cache_bytes``; chunks past that are
    cut anew on every pass. An evaluation folds the cells chunk by chunk
    with the block-local closures (their collectives over the model and
    data groups), then gathers the blocks over the model group once: the
    value and every vector come back whole ``[d_pad]`` and the same on
    every rank, so the host optimizers run on each rank alike.

    Scope (as the reference's): no normalization, the sparse layout.
    """

    def __init__(
        self,
        paths,
        fmt,
        index_map,
        stats: StreamStats,
        task,
        mesh,
        *,
        rows_per_chunk: int = 65536,
        cache_bytes: int = 2 << 30,
        sharded_cache_bytes: int = 2 << 30,
        prefetch: bool = True,
        spill_dir: Optional[str] = None,
    ):
        from photon_ml_tpu_torch.ops.losses import loss_for_task
        from photon_ml_tpu_torch.ops.normalization import identity_context
        from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

        if MODEL_AXIS not in mesh.axis_names or DATA_AXIS not in mesh.axis_names:
            raise ValueError(
                "streaming feature-sharded training needs a (data, model) "
                f"mesh, got axes {mesh.axis_names}"
            )
        self.mesh = mesh
        self.data_shards = mesh.size(DATA_AXIS)
        self.model_shards = mesh.size(MODEL_AXIS)
        self._cell_at = (mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS))
        self._groups = (mesh.groups[DATA_AXIS], mesh.groups[MODEL_AXIS])
        self.dim = index_map.size
        self.block_dim = -(-self.dim // self.model_shards)
        self.d_pad = self.model_shards * self.block_dim
        self._own = slice(
            self._cell_at[1] * self.block_dim, (self._cell_at[1] + 1) * self.block_dim
        )
        self.sharded_cache_bytes = int(sharded_cache_bytes)
        self._base = StreamingGLMObjective(
            paths, fmt, index_map, stats, task, rows_per_chunk=rows_per_chunk,
            cache_bytes=cache_bytes, prefetch=prefetch, spill_dir=spill_dir,
            kernel="scatter", device=mesh.device,
        )
        self._loss = loss_for_task(task)
        self._norm = identity_context()
        self._cells: Optional[List[Optional[object]]] = None

    def _cell(self, batch):
        from photon_ml_tpu_torch.parallel.distributed import feature_shard_sparse_batch

        cell, block_dim = feature_shard_sparse_batch(
            batch, self.dim, self.data_shards, self.model_shards, *self._cell_at,
            device=self.mesh.device,
        )
        assert block_dim == self.block_dim
        return cell

    def _sharded_chunks(self):
        """This rank's cell of every chunk, in stream order; the first pass
        builds them and keeps those that fit the budget."""
        if self._cells is None:
            built: List[Optional[object]] = []
            budget = self.sharded_cache_bytes
            for batch in self._base.chunks():
                cell = self._cell(batch)
                b = cell.batch
                nbytes = sum(
                    t.numel() * t.element_size()
                    for t in (b.indices, b.values, b.labels, b.offsets, b.weights)
                )
                if nbytes <= budget:
                    budget -= nbytes
                    built.append(cell)
                else:
                    built.append(None)
                yield cell
            self._cells = built
            return
        for i, cell in enumerate(self._cells):
            if cell is None:  # past the budget: cut from the tiers again
                cell = self._cell(next(self._base.chunks(i)))
            yield cell

    def _gather(self, block):
        from photon_ml_tpu_torch.optim.common import all_gather_last

        return all_gather_last(block, self._groups[1])

    def value_and_gradient(self, w, l2_weight=0.0):
        from photon_ml_tpu_torch.parallel.distributed import block_local_vg

        w_block = w[self._own].contiguous()
        value = w.new_zeros(())
        grad = w.new_zeros(self.block_dim)
        for cell in self._sharded_chunks():
            v, g = block_local_vg(self._loss, cell, *self._groups, 0.0, self._norm)(w_block)
            value, grad = value + v, grad + g
        value = value + 0.5 * l2_weight * torch.dot(w, w)
        return value, self._gather(grad) + l2_weight * w

    def hessian_vector(self, w, direction, l2_weight=0.0):
        from photon_ml_tpu_torch.parallel.distributed import block_local_hvp_factory

        w_block = w[self._own].contiguous()
        d_block = direction[self._own].contiguous()
        hv = w.new_zeros(self.block_dim)
        for cell in self._sharded_chunks():
            factory = block_local_hvp_factory(
                self._loss, cell, *self._groups, 0.0, self._norm
            )
            hv = hv + factory(w_block)(d_block)
        return self._gather(hv) + l2_weight * direction

    def hessian_diagonal(self, w, l2_weight=0.0):
        from photon_ml_tpu_torch.parallel.distributed import block_local_hdiag

        w_block = w[self._own].contiguous()
        diag = w.new_zeros(self.block_dim)
        for cell in self._sharded_chunks():
            diag = diag + block_local_hdiag(
                self._loss, cell, *self._groups, 0.0, self._norm
            )(w_block)
        return self._gather(diag) + l2_weight

    def close(self) -> None:
        self._cells = None
        self._base.close()
