"""Asynchronous host-device overlap: deferred readbacks, background host
prep, and async artifact IO (port of ``photon_ml_tpu/parallel/overlap.py``).

Three primitives, used across GLM/GAME training:

1. **Deferred readbacks** (:class:`Deferred` / :func:`fetch_all`): device
   scalars (objective terms, regularization terms, tracker stat vectors)
   stay on the device; consumers hold futures and ONE batched
   :func:`device_get` per outer iteration materializes them all: a
   ``non_blocking`` copy of each tensor into pinned host memory, then one
   CUDA event waited on, so the host blocks once for the whole list.
2. **Background host prep** (:func:`submit` / :func:`wait`): a worker
   thread for host work. The reference prefetches coordinate k+1's
   staging on it under coordinate k's solves; the port's CD loop runs
   its coordinates in order, since a bucket upload happens once, in the
   first update, and a second thread's upload queues on the same
   default stream as the solves (no run measured a gain).
3. **Async artifact IO** (:func:`submit_io` / :func:`drain_io`):
   checkpoint and metrics writes leave the training loop's critical path;
   a single-worker queue preserves write order and :func:`drain_io` is
   the barrier before anything that needs the files on disk (preemption
   stop, run exit).

Every device->host fetch of the GAME layer routes through
:func:`device_get`, the counting seam the readback-discipline tests
assert against (one batched readback per CD iteration, none per bucket).
Each one also counts as one of ``optim.common.host_fetches``.

Overlap is ON by default; ``--no-overlap`` on the drivers (or
``PHOTON_NO_OVERLAP=1``, or :func:`set_overlap`) falls back to serial
execution. With overlap off, ``submit`` runs inline, ``submit_io`` writes
synchronously and :class:`Deferred` values fetch eagerly, so the serial
path reads back in the order the code asks.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any, Callable, List, Optional, Sequence

__all__ = [
    "overlap_enabled",
    "set_overlap",
    "overlap_scope",
    "Deferred",
    "fetch_all",
    "device_get",
    "readback_stats",
    "reset_readback_stats",
    "submit",
    "wait",
    "submit_io",
    "drain_io",
]


# -- configuration -----------------------------------------------------------

_LOCK = threading.Lock()
_ENABLED: Optional[bool] = None


def overlap_enabled() -> bool:
    """Whether host-device overlap is active (default True; disabled by
    ``PHOTON_NO_OVERLAP=1`` / ``set_overlap(False)`` / driver
    ``--no-overlap``)."""
    global _ENABLED
    with _LOCK:
        if _ENABLED is None:
            _ENABLED = os.environ.get(
                "PHOTON_NO_OVERLAP", ""
            ).strip().lower() not in ("1", "true", "yes")
        return _ENABLED


def set_overlap(enabled: bool) -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = bool(enabled)


@contextmanager
def overlap_scope(enabled: bool):
    """Temporarily force overlap on/off (A/B harnesses, parity tests)."""
    global _ENABLED
    with _LOCK:
        prev = _ENABLED
        _ENABLED = bool(enabled)
    try:
        yield
    finally:
        with _LOCK:
            _ENABLED = prev


# -- readback seam -----------------------------------------------------------
#
# ALL device->host fetches in the GAME layer go through device_get so the
# regression tests can count them: the profiler covers device time, this
# covers the transfer discipline (each fetch stalls the host until the
# device drains its queue).

_READBACK_CALLS = 0


def _tensors(tree, out):
    """The tensors of a nested list / tuple / dict, in order."""
    import torch

    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _rebuild(tree, host):
    """``tree`` with each tensor replaced by the next numpy array of
    ``host``."""
    import torch

    if torch.is_tensor(tree):
        return next(host)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, host) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(x, host) for k, x in tree.items()}
    return tree


def device_get(tree):
    """The one device->host fetch of a nested list / tuple / dict of
    tensors -> the same structure with numpy arrays (0-d for scalars).
    CUDA tensors are copied ``non_blocking`` into pinned host buffers and
    one CUDA event is waited on, so the host blocks once; counted here
    and in ``optim.common.host_fetches``."""
    global _READBACK_CALLS
    import torch

    from photon_ml_tpu_torch.optim import common

    with _LOCK:
        _READBACK_CALLS += 1
    common.host_fetches += 1
    tensors = _tensors(tree, [])
    host = []
    event = None
    for t in tensors:
        t = t.detach()
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            host.append(buf)
            if event is None:
                event = torch.cuda.Event()
        else:
            host.append(t)
    if event is not None:
        event.record()
        event.synchronize()
    return _rebuild(tree, iter([h.numpy() for h in host]))


def readback_stats() -> int:
    """Number of device_get calls since the last reset."""
    with _LOCK:
        return _READBACK_CALLS


def reset_readback_stats() -> None:
    global _READBACK_CALLS
    with _LOCK:
        _READBACK_CALLS = 0


# -- deferred readbacks ------------------------------------------------------


class Deferred:
    """A device-resident value plus a host-side ``finalize``: the future
    half of a batched readback.

    ``device_value`` may be any nested list / tuple / dict of tensors. ``finalize``
    (host_tree -> result) runs exactly once, after the fetch. ``result()``
    forces an INDIVIDUAL fetch when the value was never batch-fetched —
    correctness never depends on the batching, only latency does. With
    overlap disabled the fetch happens eagerly at construction, so serial
    runs see the exact pre-overlap readback order.
    """

    __slots__ = ("_device", "_finalize", "_result", "_done")

    def __init__(self, device_value, finalize: Optional[Callable] = None):
        self._device = device_value
        self._finalize = finalize
        self._result = None
        self._done = False
        if not overlap_enabled():
            self._deliver(device_get(device_value))

    def _deliver(self, host_value) -> None:
        if self._done:
            return
        self._result = (
            self._finalize(host_value) if self._finalize else host_value
        )
        self._done = True
        self._device = None  # release the device reference

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            self._deliver(device_get(self._device))
        return self._result


def fetch_all(deferreds: Sequence[Optional[Deferred]]) -> None:
    """Materialize every pending Deferred with ONE batched device_get
    (one transfer round trip for the whole list)."""
    pending = [d for d in deferreds if d is not None and not d.done]
    if not pending:
        return
    host = device_get([d._device for d in pending])
    for d, h in zip(pending, host):
        d._deliver(h)


# -- background host prep ----------------------------------------------------
#
# One worker: prep tasks are already coarse (a whole coordinate's staging)
# and a single thread keeps cache mutations race-free by construction —
# the main thread only touches a coordinate AFTER wait()ing on its prep.

_PREP_POOL = None
_IO_POOL = None
_IO_PENDING: List = []
# (artifact, exception) of failed async writes, in submission order. The
# worker wrapper records instead of raising so the FIFO keeps draining
# the writes QUEUED BEHIND a failure; drain_io() re-raises the first one
# with its artifact name — a failed checkpoint/part-file write can never
# masquerade as success.
_IO_FAILURES: List = []


def _pool(which: str):
    global _PREP_POOL, _IO_POOL
    from concurrent.futures import ThreadPoolExecutor

    with _LOCK:
        if which == "prep":
            if _PREP_POOL is None:
                _PREP_POOL = ThreadPoolExecutor(
                    1, thread_name_prefix="photon-overlap-prep"
                )
            return _PREP_POOL
        if _IO_POOL is None:
            _IO_POOL = ThreadPoolExecutor(
                1, thread_name_prefix="photon-overlap-io"
            )
        return _IO_POOL


class _InlineFuture:
    """Future facade for the overlap-off path: runs eagerly on submit."""

    __slots__ = ("_result", "_exc")

    def __init__(self, fn, args, kwargs):
        self._exc = None
        self._result = None
        try:
            self._result = fn(*args, **kwargs)
        except BaseException as e:  # re-raised on result(), like a Future
            self._exc = e

    def result(self):
        if self._exc is not None:
            raise self._exc
        return self._result


def submit(fn: Callable, *args, **kwargs):
    """Run ``fn`` on the prep worker (overlap on) or inline (overlap
    off); returns a future either way."""
    if not overlap_enabled():
        return _InlineFuture(fn, args, kwargs)
    return _pool("prep").submit(fn, *args, **kwargs)


def wait(future) -> Any:
    """Block on a future from :func:`submit` (None passes through)."""
    if future is None:
        return None
    return future.result()


# -- async artifact IO -------------------------------------------------------


def submit_io(fn: Callable, *args, artifact: str = "", **kwargs) -> None:
    """Queue an artifact write (checkpoint step, metrics.json) on the IO
    worker; FIFO order is preserved. Overlap off -> synchronous write.

    ``artifact`` names what is being written — it travels with any
    failure to :func:`drain_io` so the error is attributable. The write
    runs behind the reliability layer's ``io_worker`` seam (fault
    injection + bounded retries)."""
    from photon_ml_tpu_torch.reliability.retry import io_call

    if not overlap_enabled():
        io_call("io_worker", fn, *args, detail=artifact, **kwargs)
        return

    def _guarded() -> None:
        try:
            io_call("io_worker", fn, *args, detail=artifact, **kwargs)
        except BaseException as e:
            with _LOCK:
                _IO_FAILURES.append((artifact, e))

    pool = _pool("io")  # resolves OUTSIDE _LOCK (it takes _LOCK itself)
    with _LOCK:
        _IO_PENDING.append(pool.submit(_guarded))


def drain_io() -> None:
    """Barrier: every queued IO write is on disk (or raised) after this.
    Call before anything that requires the artifacts — preemption stop,
    checkpoint restore, run exit. The FIRST recorded worker failure
    re-raises here with its artifact name (later queued writes still
    drained first — write order stays FIFO even across a failure)."""
    while True:
        with _LOCK:
            if not _IO_PENDING:
                break
            fut = _IO_PENDING.pop(0)
        fut.result()  # _guarded never raises; this waits completion
    with _LOCK:
        if not _IO_FAILURES:
            return
        artifact, exc = _IO_FAILURES[0]
        _IO_FAILURES.clear()
    raise RuntimeError(
        "async artifact write failed"
        + (f" for {artifact!r}" if artifact else "")
        + f": {exc}"
    ) from exc
