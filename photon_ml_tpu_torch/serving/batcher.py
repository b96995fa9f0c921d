"""Micro-batching request loop: admit, coalesce, pad, dispatch, demux
(port of ``photon_ml_tpu/serving/batcher.py``; the device work is the
programs' CUDA graphs and the one readback ``overlap.device_get``).

The Podracer idiom (PAPERS.md): the serving loop is its own component —
it never blocks on training, model publication, or artifact IO. Here it
also never blocks on the DEVICE more than one dispatch at a time:
concurrent submitters enqueue; a single dispatcher thread drains the
queue into the smallest padded ladder shape that fits, runs ONE
precompiled device program, performs exactly ONE counted readback
(``overlap.device_get``) and resolves each request's future with its own
row.

Batching is continuous by default (``max_wait_s = 0``): whatever
accumulated while the previous dispatch executed forms the next batch,
so an idle service answers a lone request at shape 1 with zero imposed
wait, and a saturated service coalesces to the ladder cap without any
timer tuning. ``max_wait_s > 0`` forces coalescing for bursty open-loop
sources.

Overload discipline (the Orca-style continuous-batching contract,
PAPERS.md): admission happens at ``submit`` — a request whose
client-propagated ``deadline_ms`` is already beaten by the predicted
queue wait is SHED immediately (:class:`~.admission.RequestShed`), and
a full queue blocks a submitter only for the request's own remaining
budget, never indefinitely. Requests whose deadline expires while
queued are dropped *before* dispatch (the device never scores dead
work). Every accepted request reaches exactly one terminal state:
a :class:`~.admission.ScoreOutcome`, or one of the named
``ServingError`` failures — including :class:`~.admission.DrainTimeout`
for requests still pending when a bounded ``drain`` runs out of budget.

Graceful degradation: when a random-effect bank is quarantined (or its
row resolution fails mid-swap), the batch scores FE-ONLY for the
affected rows — bitwise what the batch scorer produces for an unknown
entity — and the outcome carries ``degraded=True`` instead of an error.

Request assembly lives here too: :func:`requests_from_dataset` turns a
``GameDataset`` into per-row requests (the file-replay path — identical
padding/width to the batch scorer, which is what the bitwise parity bar
needs), and :func:`request_from_record` maps one raw record dict
through prebuilt index maps (the stdin/front-end path).
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder
from photon_ml_tpu_torch.obs.trace import (
    PARENT_KEY,
    TRACE_KEY,
    record_span,
    tracing_enabled,
)
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.serving.admission import (
    AdmissionController,
    BatcherClosed,
    DeadlineExceeded,
    DrainTimeout,
    PartialScore,
    RequestShed,
    ScoreOutcome,
)
from photon_ml_tpu_torch.serving.model_bank import ModelBank
from photon_ml_tpu_torch.serving.programs import (
    RequestBatch,
    ServingPrograms,
    select_shape,
    term_entries,
)

__all__ = [
    "ScoreRequest",
    "MicroBatcher",
    "DrainReport",
    "request_from_record",
    "requests_from_dataset",
]

_NO_LOCK = contextlib.nullcontext()

# How long a submitter without a deadline may block on a full queue
# before it is shed: backpressure stays bounded even for clients that
# declared no latency budget of their own.
DEFAULT_SUBMIT_WAIT_S = 30.0
# score()'s result bound when the request carries no deadline — a
# request path where ANY wait is unbounded is exactly what PL007
# (request-path-hygiene) exists to reject.
DEFAULT_RESULT_TIMEOUT_S = 600.0
# Slack past the deadline for score()'s result wait: the dispatch a
# request was admitted into may still be executing when its queue
# deadline passes.
RESULT_DEADLINE_SLACK_S = 30.0
# Idle dispatcher wake-up period: each pass refreshes the liveness
# heartbeat, so "dispatcher alive" is a recent timestamp, not a guess.
HEARTBEAT_INTERVAL_S = 0.25
# Consecutive row-resolution failures on one RE type before the bank
# quarantines that coordinate (every later request scores FE-only
# without paying the failing lookup again).
RE_QUARANTINE_AFTER = 3


def _resolve(fut: Future, *, result=None, error: Optional[BaseException] = None) -> bool:
    """Resolve a future exactly once; racing resolvers (dispatcher vs
    drain-timeout) both go through here, so a lost race is a no-op, not
    a crash."""
    if fut.done():
        return False
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:
        return False


@dataclass
class ScoreRequest:
    """One scoring request: per-shard padded (indices, values) rows at
    the bank's shard widths, plus RAW entity ids. Entity ids resolve to
    bank rows at DISPATCH time, against the bank the batch actually
    runs on — never at build time. A request is therefore valid across
    hot swaps: a generation flip that keeps device shapes but changes
    the entity set (the exact case entity padding preserves) re-resolves
    every queued and replayed request against the new generation's rows
    instead of scoring stale ones."""

    uid: str
    indices: Dict[str, np.ndarray]  # shard -> int32 [k]
    values: Dict[str, np.ndarray]  # shard -> float32 [k]
    entity_ids: Dict[str, Optional[str]]  # id type -> raw id (None = absent)
    offset: float = 0.0
    # client-propagated latency budget in milliseconds from enqueue;
    # None = no deadline (bounded only by the batcher's own submit cap)
    deadline_ms: Optional[float] = None
    # passthrough columns for the scores artifact (batch-scorer record
    # layout); never touch the device
    label: Optional[float] = None
    weight: float = 1.0
    metadata: Optional[Dict[str, str]] = None
    # end-to-end tracing (obs/trace.py): the wire-carried trace id and
    # the parent span the dispatch-window span nests under. Host-only
    # annotations — they never touch the device path.
    trace_id: Optional[str] = None
    parent_span: Optional[str] = None
    _enqueue_t: float = field(default=0.0, repr=False)

    def expired(self, now: float) -> bool:
        return (
            self.deadline_ms is not None
            and (now - self._enqueue_t) * 1e3 > self.deadline_ms
        )


@dataclass
class DrainReport:
    """What a bounded drain did: how many requests were pending when it
    started, how many completed inside the budget, how many were failed
    with :class:`DrainTimeout`, and whether the dispatcher exited."""

    pending_at_start: int = 0
    completed: int = 0
    failed: int = 0
    duration_s: float = 0.0
    timed_out: bool = False

    def to_dict(self) -> Dict[str, object]:
        return {
            "pending_at_start": self.pending_at_start,
            "completed": self.completed,
            "failed": self.failed,
            "duration_s": round(self.duration_s, 6),
            "timed_out": self.timed_out,
        }


def request_from_record(
    record: Mapping,
    bank: ModelBank,
    shard_configs,
    *,
    has_response: bool = True,
) -> ScoreRequest:
    """One raw GameExample-shaped dict -> ScoreRequest through the
    bank's index maps (the stdin/JSON and network front-end path; the
    Avro replay path goes through :func:`requests_from_dataset`)."""
    from photon_ml_tpu_torch.game.data import record_response
    from photon_ml_tpu_torch.utils.index_map import feature_key, intercept_key

    indices: Dict[str, np.ndarray] = {}
    values: Dict[str, np.ndarray] = {}
    for cfg in shard_configs:
        imap = bank.index_maps[cfg.shard_id]
        k = bank.shard_widths[cfg.shard_id]
        ix = np.zeros((k,), np.int32)
        vs = np.zeros((k,), np.float32)
        pos = 0
        for bag in cfg.feature_bags:
            for f in record.get(bag) or []:
                j = imap.get_index(feature_key(f["name"], f["term"]))
                if j < 0:
                    continue  # unknown feature: dropped, like the builder
                if pos >= k:
                    raise ValueError(
                        f"request {record.get('uid')!r} exceeds shard "
                        f"{cfg.shard_id!r} width {k}"
                    )
                ix[pos] = j
                vs[pos] = float(f["value"])
                pos += 1
        if cfg.add_intercept:
            j = imap.get_index(intercept_key())
            if j >= 0:
                if pos >= k:
                    raise ValueError(
                        f"request {record.get('uid')!r} exceeds shard "
                        f"{cfg.shard_id!r} width {k}"
                    )
                ix[pos] = j
                vs[pos] = 1.0
                pos += 1
        indices[cfg.shard_id] = ix
        values[cfg.shard_id] = vs
    # raw ids only — the dispatcher resolves them against whichever
    # bank generation the batch runs on. A record missing an id type
    # scores FE-only (unknown-entity semantics), and its key is OMITTED
    # from metadata (never the literal "None"), matching the dataset
    # path's records.
    entity_ids: Dict[str, Optional[str]] = {}
    for t in bank.re_types:
        v = record.get(t)
        if v is None:
            v = (record.get("metadataMap") or {}).get(t)
        entity_ids[t] = None if v is None else str(v)
    off = record.get("offset")
    wgt = record.get("weight")
    uid = record.get("uid")
    deadline = record.get("deadline_ms")
    trace_id = record.get(TRACE_KEY)
    parent_span = record.get(PARENT_KEY)
    meta = {t: e for t, e in entity_ids.items() if e is not None}
    return ScoreRequest(
        uid="" if uid is None else str(uid),
        indices=indices,
        values=values,
        entity_ids=entity_ids,
        offset=0.0 if off is None else float(off),
        deadline_ms=None if deadline is None else float(deadline),
        label=(
            record_response(record, True) if has_response else None
        ),
        weight=1.0 if wgt is None else float(wgt),
        metadata=meta or None,
        trace_id=None if trace_id is None else str(trace_id),
        parent_span=None if parent_span is None else str(parent_span),
    )


def requests_from_dataset(ds, bank: ModelBank) -> List[ScoreRequest]:
    """Per-row requests from a GameDataset built with the bank's index
    maps — row slices are views. Requests carry the RAW entity id
    strings (the dataset's codes index the dataset's own entity table,
    not the model's); the dispatcher resolves id -> bank row against
    whichever generation each batch runs on, so a replayed trace stays
    correct across hot swaps whose entity sets differ. ``bank`` pins the
    per-shard widths the AOT program shapes were compiled for."""
    for sid, k in bank.shard_widths.items():
        sd = ds.shards.get(sid)
        if sd is None or sd.indices.shape[1] != k:
            got = None if sd is None else sd.indices.shape[1]
            raise ValueError(
                f"dataset shard {sid!r} width {got!r} != bank request "
                f"width {k} (the trace must be built at the bank's "
                "padded layout)"
            )
    out: List[ScoreRequest] = []
    id_types = sorted(ds.entity_indexes)
    for i in range(ds.num_real_rows):
        entity_ids = {
            t: (
                ds.entity_indexes[t].ids[int(ds.entity_codes[t][i])]
                if int(ds.entity_codes[t][i]) >= 0
                else None
            )
            for t in id_types
        }
        meta = {t: e for t, e in entity_ids.items() if e is not None}
        out.append(
            ScoreRequest(
                uid=ds.uids[i],
                indices={
                    sid: sd.indices[i] for sid, sd in ds.shards.items()
                },
                values={
                    sid: sd.values[i] for sid, sd in ds.shards.items()
                },
                entity_ids=entity_ids,
                offset=float(ds.offsets[i]),
                label=float(ds.labels[i]),
                weight=float(ds.weights[i]),
                metadata=meta or None,
            )
        )
    return out


class MicroBatcher:
    """Bounded-queue micro-batcher over a live bank reference.

    ``bank_ref`` is a zero-arg callable returning the CURRENT ModelBank
    — the hot-swap seam: the dispatcher reads it once per dispatch, so a
    generation flip lands exactly on a batch boundary, never inside one.
    """

    def __init__(
        self,
        bank_ref: Callable[[], ModelBank],
        programs: ServingPrograms,
        metrics=None,
        *,
        max_wait_s: float = 0.0,
        max_queue: int = 4096,
        swap_lock: Optional[threading.Lock] = None,
        admission: Optional[AdmissionController] = None,
        default_deadline_ms: Optional[float] = None,
        max_submit_wait_s: float = DEFAULT_SUBMIT_WAIT_S,
        partial: Optional[bool] = None,
        recorder=None,
    ):
        self._bank_ref = bank_ref
        self._programs = programs
        self._metrics = metrics
        # conservation ledger target: the process flight recorder by
        # default; in-process fleets (tests, bench rigs) pass each
        # member its OWN recorder so the per-member books stay separate
        self._flight = recorder if recorder is not None else flight_recorder()
        # exclusion against a DONATING hot swap (see ServingModel.
        # dispatch_lock): inferred from a bound ServingModel.current
        # bank_ref so the safe wiring is the default wiring
        owner = getattr(bank_ref, "__self__", None)
        self._swap_lock = (
            swap_lock
            if swap_lock is not None
            else getattr(owner, "dispatch_lock", None)
        )
        # shard-server mode: dispatch the scatter/gather partial
        # program (fe + per-coordinate terms) and resolve futures with
        # PartialScore instead of ScoreOutcome. Like the swap lock, the
        # mode is inferred from a bound ServingModel so the safe wiring
        # is the default wiring.
        self._partial = (
            bool(partial)
            if partial is not None
            else bool(getattr(owner, "partial", False))
        )
        self._max_wait_s = float(max_wait_s)
        self._max_queue = int(max_queue)
        self._admission = admission or AdmissionController()
        self._default_deadline_ms = (
            None if default_deadline_ms is None else float(default_deadline_ms)
        )
        self._max_submit_wait_s = float(max_submit_wait_s)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._queue: List = []  # (ScoreRequest, Future)
        self._inflight: List = []  # the take a dispatch is executing
        self._closed = False
        self._draining = False
        # dispatcher-thread-local scratch (never read off-thread)
        self._re_fail_counts: Dict[str, int] = {}
        # single-writer atomic publish: only the dispatcher stamps it
        # (plain float assignment), liveness probes read it bare — a
        # heartbeat behind a lock would measure the lock, not the loop
        self._last_heartbeat = time.perf_counter()  # photon: guarded-by(atomic)
        self._worker = threading.Thread(
            target=self._dispatch_loop,
            name="photon-serving-dispatch",
            daemon=True,
        )
        self._worker.start()

    # -- liveness ------------------------------------------------------------

    def alive(self) -> bool:
        """Dispatcher liveness: the worker thread exists and is running
        (it exits only after close/drain)."""
        return self._worker.is_alive()

    def heartbeat_age_s(self) -> float:
        """Seconds since the dispatcher last crossed its loop — it beats
        at least every ``HEARTBEAT_INTERVAL_S`` even when idle, so a
        large age means a wedged (not merely idle) dispatcher."""
        return time.perf_counter() - self._last_heartbeat

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._inflight)

    # -- submit side ---------------------------------------------------------

    def submit(self, request: ScoreRequest) -> Future:
        """Admit one request, or refuse it NOW with a named error.

        Admission control (all under the queue lock, all O(1)):

        - closed/draining batcher -> :class:`BatcherClosed`;
        - predicted queue wait past the request's ``deadline_ms`` ->
          :class:`RequestShed` immediately (no queue slot consumed);
        - full queue -> block at most the request's remaining deadline
          (or ``max_submit_wait_s`` for deadline-less requests), then
          :class:`RequestShed`. The indefinite block is gone: every
          submit returns or raises in bounded time.
        """
        fut: Future = Future()
        now = time.perf_counter()
        request._enqueue_t = now
        if request.deadline_ms is None:
            request.deadline_ms = self._default_deadline_ms
        wait_budget_s = (
            request.deadline_ms / 1e3
            if request.deadline_ms is not None
            else self._max_submit_wait_s
        )
        limit = now + wait_budget_s
        # shed accounting happens AFTER the lock is released (PL010
        # atomicity-hygiene): the metrics object has its own lock, and
        # a foreign critical section inside the Condition-backed queue
        # lock stalls the dispatcher and every parked submitter.
        # predicted_wait_s is lock-free by design (single-writer EWMA).
        try:
            with self._lock:
                if self._closed or self._draining:
                    raise BatcherClosed("batcher is closed")
                if request.deadline_ms is not None:
                    predicted = self._admission.predicted_wait_s(
                        len(self._queue)
                    )
                    if predicted * 1e3 > request.deadline_ms:
                        raise RequestShed(
                            f"predicted queue wait {predicted * 1e3:.1f}"
                            f"ms exceeds deadline "
                            f"{request.deadline_ms:.1f}ms "
                            f"(queue depth {len(self._queue)})",
                            reason="predicted_wait",
                        )
                while len(self._queue) >= self._max_queue:
                    if self._closed or self._draining:
                        raise BatcherClosed("batcher is closed")
                    remaining = limit - time.perf_counter()
                    if remaining <= 0:
                        raise RequestShed(
                            f"queue full ({self._max_queue}) past the "
                            "request's wait budget "
                            f"{wait_budget_s * 1e3:.1f}ms",
                            reason="queue_full",
                        )
                    self._space.wait(timeout=remaining)
                if self._closed or self._draining:
                    raise BatcherClosed("batcher is closed")
                self._queue.append((request, fut))
                self._nonempty.notify()
        except RequestShed as e:
            if self._metrics is not None:
                self._metrics.record_shed(e.reason)
            # structured overload event + (refused-before-admission, so
            # it enters neither side of the conservation ledger)
            self._flight.record("request.shed", reason=e.reason)
            raise
        # conservation ledger (obs/flight_recorder.py): one admitted
        # mark per queued request; every resolution site below marks
        # the matching terminal — check_conservation() is the
        # every-request-reaches-a-named-outcome invariant. Fed OUTSIDE
        # the queue lock, like the shed accounting above.
        self._flight.note_admitted()
        return fut

    def score(
        self, request: ScoreRequest, timeout: Optional[float] = None
    ) -> ScoreOutcome:
        """Closed-loop convenience: submit and wait — bounded. The wait
        is the request's own deadline plus dispatch slack (the batch it
        was admitted into still has to execute), or the module default
        for deadline-less requests."""
        fut = self.submit(request)
        if timeout is None:
            timeout = (
                request.deadline_ms / 1e3 + RESULT_DEADLINE_SLACK_S
                if request.deadline_ms is not None
                else DEFAULT_RESULT_TIMEOUT_S
            )
        return fut.result(timeout=timeout)

    def close(self) -> None:
        """Serve everything queued, then stop the dispatcher. Idempotent.
        Submitters blocked on a full queue are woken (both conditions
        notified) and raise instead of hanging."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._nonempty.notify_all()
            self._space.notify_all()
        self._worker.join()

    def drain(self, timeout_s: float) -> DrainReport:
        """Bounded shutdown: stop admitting, serve what is already
        queued for up to ``timeout_s``, then fail every still-pending
        future with :class:`DrainTimeout` — one terminal outcome per
        request, zero hung futures, whatever state the device is in.
        """
        t0 = time.perf_counter()
        deadline = t0 + max(float(timeout_s), 0.0)
        leftovers: Optional[List] = None  # None = was already closed
        pending_at_start = 0
        with self._lock:
            if not self._closed:
                self._draining = True
                pending_at_start = len(self._queue) + len(self._inflight)
                # wake blocked submitters (they raise BatcherClosed)
                # and an idle dispatcher
                self._nonempty.notify_all()
                self._space.notify_all()
                while self._queue or self._inflight:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    # _space is notified after every take AND after
                    # every dispatch completion, so this wakes as work
                    # finishes
                    self._space.wait(timeout=min(remaining, 0.05))
                leftovers = list(self._queue) + list(self._inflight)
                self._queue.clear()
                self._closed = True
                self._nonempty.notify_all()
                self._space.notify_all()
        if leftovers is None:
            # already closed: accounting outside the queue lock (PL010
            # atomicity-hygiene — record_drain takes the metrics lock)
            report = DrainReport(duration_s=time.perf_counter() - t0)
            if self._metrics is not None:
                self._metrics.record_drain(report)
            return report
        failed = 0
        for _req, fut in leftovers:
            if _resolve(fut, error=DrainTimeout(
                "request still pending when the drain budget "
                f"({timeout_s:.3f}s) ran out"
            )):
                failed += 1
        if failed:
            self._flight.note_terminal("drain_timeout", n=failed)
        join_budget = max(deadline - time.perf_counter(), 0.0) + 1.0
        self._worker.join(timeout=join_budget)
        report = DrainReport(
            pending_at_start=pending_at_start,
            completed=pending_at_start - failed,
            failed=failed,
            duration_s=time.perf_counter() - t0,
            timed_out=bool(failed) or self._worker.is_alive(),
        )
        if self._metrics is not None:
            self._metrics.record_drain(report)
        return report

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatch side -------------------------------------------------------

    def _take(self) -> List:
        """Block until work exists (waking periodically to beat the
        liveness heartbeat), optionally linger ``max_wait_s`` for
        coalescing, then claim up to ``max(ladder)`` requests."""
        cap = self._programs.ladder[-1]
        with self._lock:
            while not self._queue and not self._closed:
                self._nonempty.wait(timeout=HEARTBEAT_INTERVAL_S)
                self._last_heartbeat = time.perf_counter()
            if not self._queue:
                return []  # closed and drained
            if self._max_wait_s > 0.0 and not self._draining:
                deadline = self._queue[0][0]._enqueue_t + self._max_wait_s
                while (
                    len(self._queue) < cap
                    and not self._closed
                    and (remaining := deadline - time.perf_counter()) > 0
                ):
                    self._nonempty.wait(timeout=remaining)
                    self._last_heartbeat = time.perf_counter()
            take = self._queue[:cap]
            del self._queue[:cap]
            self._inflight = list(take)
            self._space.notify_all()
            return take

    def _finish_take(self) -> None:
        with self._lock:
            self._inflight = []
            # drain() parks on _space waiting for inflight to clear
            self._space.notify_all()

    def _expire_dead(self, take: List) -> List:
        """Drop requests whose deadline passed while they queued —
        BEFORE assembly, so the device never scores dead work. Each
        dropped future fails with the named DeadlineExceeded outcome."""
        now = time.perf_counter()
        live: List = []
        expired = 0
        for req, fut in take:
            if req.expired(now):
                waited_ms = (now - req._enqueue_t) * 1e3
                if _resolve(fut, error=DeadlineExceeded(
                    f"deadline {req.deadline_ms:.1f}ms exceeded after "
                    f"{waited_ms:.1f}ms in queue"
                )):
                    expired += 1
            else:
                live.append((req, fut))
        if expired:
            if self._metrics is not None:
                self._metrics.record_deadline_expired(expired)
            fr = self._flight
            fr.record("request.deadline", expired=expired)
            fr.note_terminal("deadline_exceeded", n=expired)
        return live

    def _dispatch_loop(self) -> None:
        while True:
            self._last_heartbeat = time.perf_counter()
            take = self._take()
            if not take:
                return
            try:
                take = self._expire_dead(take)
                if take:
                    self._dispatch(take)
            except BaseException as e:  # resolve, never wedge submitters
                errored = 0
                for _req, fut in take:
                    errored += int(_resolve(fut, error=e))
                if errored:
                    self._flight.note_terminal(
                        "dispatch_error", n=errored
                    )
            finally:
                self._finish_take()

    def _assemble(self, requests: List[ScoreRequest], bank: ModelBank,
                  B: int):
        n = len(requests)
        indices: Dict[str, np.ndarray] = {}
        values: Dict[str, np.ndarray] = {}
        # only the shards the SPEC scores: requests may carry more
        # (an FE-only model under a multi-shard request config), but
        # the compiled program's pytree holds exactly the spec's shards
        for sid in bank.used_shards:
            k = bank.shard_widths[sid]
            ix = np.zeros((B, k), np.int32)
            vs = np.zeros((B, k), np.float32)
            for i, r in enumerate(requests):
                ix[i] = r.indices[sid]
                vs[i] = r.values[sid]
            indices[sid] = ix
            values[sid] = vs
        # resolve raw entity ids against the bank THIS batch dispatches
        # on (one vectorized rows_of per id type): requests pre-built or
        # queued before a hot swap score the new generation's rows, not
        # stale build-time ones. A quarantined RE bank — or a lookup
        # that fails outright (e.g. the native index store dying
        # mid-swap) — degrades those rows to FE-only (code -1, the
        # batch scorer's unknown-entity semantics) instead of failing
        # the whole batch.
        degraded = np.zeros((B,), bool)
        codes: Dict[str, np.ndarray] = {}
        for t in bank.re_types:
            c = np.full((B,), -1, np.int32)
            present: List[int] = []
            ids: List[str] = []
            for i, r in enumerate(requests):
                e = r.entity_ids.get(t) if r.entity_ids else None
                if e is not None:
                    present.append(i)
                    ids.append(e)
            if present:
                rows_at = np.asarray(present)
                if t in bank.quarantined_re_types:
                    degraded[rows_at] = True
                else:
                    try:
                        c[rows_at] = bank.entity_rows[t].rows_of(ids)
                        self._re_fail_counts.pop(t, None)
                    except Exception as e:
                        degraded[rows_at] = True
                        fails = self._re_fail_counts.get(t, 0) + 1
                        self._re_fail_counts[t] = fails
                        if fails >= RE_QUARANTINE_AFTER:
                            bank.quarantine_re(t)
                            if self._metrics is not None:
                                self._metrics.record_re_quarantine(t)
                        if self._metrics is not None:
                            self._metrics.record_re_resolution_failure(t)
            codes[t] = c
        offsets = np.zeros((B,), np.float32)
        offsets[:n] = [r.offset for r in requests]
        batch = RequestBatch(
            indices=indices, values=values, codes=codes, offsets=offsets
        )
        return batch, degraded

    def _dispatch(self, take: List) -> None:
        from photon_ml_tpu_torch.reliability import io_call

        t0 = time.perf_counter()
        requests = [r for r, _ in take]
        # the whole device section (bank read -> assemble -> execute ->
        # readback) is exclusive with a donating hot swap, so a flip
        # lands BETWEEN batches and can never invalidate the buffers of
        # one in flight; uncontended, the lock costs nanoseconds
        lock = self._swap_lock if self._swap_lock is not None else _NO_LOCK

        def _run():
            with lock:
                bank = self._bank_ref()
                B = select_shape(len(requests), self._programs.ladder)
                batch, degraded = self._assemble(requests, bank, B)
                if self._partial:
                    # fe + terms fetched as ONE batched transfer — the
                    # readback budget is unchanged in shard mode
                    scores_dev = self._programs.score_partial(bank, batch)
                else:
                    scores_dev = self._programs.score(bank, batch)
                # the ONE counted device->host transfer for this batch
                scores = overlap.device_get(scores_dev)
            return bank, B, degraded, scores

        # the serving.dispatch reliability seam: dispatch is idempotent
        # (pure compute + readback), so a planned transient fault is
        # retried bitwise; an exhausted budget fails the batch's futures
        # with a SeamFailure NAMING the seam — one terminal outcome each
        bank, B, degraded, scores = io_call(
            "serving.dispatch", _run,
            detail=f"{len(requests)} request(s)",
        )
        t1 = time.perf_counter()
        self._admission.note_dispatch(rows=len(requests), busy_s=t1 - t0)
        n_degraded = 0
        n_ok = 0
        if self._partial:
            fe, terms = scores
            names = tuple(e[1] for e in term_entries(bank.spec))
            n_terms = len(names)
        traced = []
        collect_traces = tracing_enabled()
        for i, (req, fut) in enumerate(take):
            deg = bool(degraded[i])
            n_degraded += int(deg)
            if collect_traces and req.trace_id is not None:
                # per-request trace contexts ride the DISPATCH span as
                # one attr; the serving.score leaves are synthesized at
                # export (trace.expand_spans) — the hot path pays one
                # tuple per traced request, not one span
                traced.append((req.trace_id, req.parent_span, deg))
            if self._partial:
                # vector form: the f32 term row rides the outcome as-is
                # (no per-float dict build); the JSON wire materializes
                # float(np.float32) lazily — the exact f64 of the f32
                # bits — and the binary wire ships the raw bits
                n_ok += int(_resolve(fut, result=PartialScore.from_vector(
                    float(fe[i]),
                    names,
                    terms[i, :n_terms],
                    offset=req.offset,
                    degraded=deg,
                    generation=bank.generation,
                )))
            else:
                n_ok += int(_resolve(fut, result=ScoreOutcome(
                    float(scores[i]), degraded=deg,
                    generation=bank.generation,
                )))
        if n_ok:
            self._flight.note_terminal(
                "ok", generation=bank.generation, n=n_ok
            )
        # stamped AFTER the device section from timestamps already in
        # hand — record_span is a no-op branch when tracing is off and
        # a lock-free ring append when on, so the locked device section
        # above acquires nothing new.
        record_span(
            "serving.dispatch", t0, t1,
            shape=B, occupancy=len(requests), generation=bank.generation,
            partial=self._partial,
            **({"traces": traced} if traced else {}),
        )
        if self._metrics is not None:
            if n_degraded:
                self._metrics.record_degraded(n_degraded)
            self._metrics.record_dispatch(
                shape=B,
                occupancy=len(requests),
                queue_wait_s=t0 - min(r._enqueue_t for r in requests),
                device_s=t1 - t0,
                generation=bank.generation,
            )
            done = time.perf_counter()
            for req in requests:
                self._metrics.record_latency(done - req._enqueue_t)
