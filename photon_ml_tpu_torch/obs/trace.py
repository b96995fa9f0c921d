"""End-to-end request + training tracing: lightweight host-side spans
with wire propagation and Chrome trace-event export (a copy of
``photon_ml_tpu/obs/trace.py``, retargeted at the port's atomic writer).

The unified-telemetry half the ``torch.profiler`` device timelines cannot
give us: WHERE a request (or a CD iteration) spent its wall time across
the fleet — frontend accept, router scatter, shard-server dispatch,
micro-batch execution — correlated by one trace id minted at the edge
and carried on the wire in the request/response JSON
(``trace_id`` / ``parent_span`` keys; see :data:`TRACE_KEY`).

Design constraints, in priority order:

- **Host arithmetic only.** Nothing in this module (or anywhere in
  ``photon_ml_tpu_torch/obs/``) may touch a device tensor — telemetry
  must never add a device sync, a capture, or a readback.
- **No locks on the dispatch hot path.** Span ids come from
  ``itertools.count`` (atomic at the C level) and finished spans land
  in a bounded ``collections.deque`` (``maxlen`` ring — atomic append
  under the GIL). Recording a span acquires NO lock, so tracing can
  stay on in production without adding a contention point to the
  batcher's device section. ``drain()`` swaps the ring under the
  tracer's own lock (never taken by ``record``/``end``).
- **Off by default, free when off.** ``tracing_enabled()`` is one
  module-global read; every instrumentation site calls ``span()`` /
  ``start_span()`` which return the no-op singleton when disabled —
  the disabled path is a branch.

Timestamps are ``time.perf_counter()`` pairs mapped onto the wall clock
through one (wall, perf) epoch captured at import, so spans from one
process share a consistent timeline and export directly as Chrome
trace-event JSON (``ph: "X"`` complete events) that loads in Perfetto /
``chrome://tracing`` NEXT TO a ``--profile-dir`` device trace captured
in the same run.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Mapping, Optional

__all__ = [
    "TRACE_KEY",
    "PARENT_KEY",
    "Span",
    "Tracer",
    "tracer",
    "reset_tracer",
    "tracing_enabled",
    "set_tracing",
    "tracing_scope",
    "span",
    "start_span",
    "record_span",
    "traced",
    "expand_spans",
    "TRACES_ATTR",
    "new_trace_id",
    "wire_context",
    "epoch",
    "epoch_now",
    "chrome_trace_events",
    "export_chrome_trace",
]

# Wire keys: a request JSON object carrying these joins the sender's
# trace; responses echo TRACE_KEY so the client can stitch both sides.
TRACE_KEY = "trace_id"
PARENT_KEY = "parent_span"

DEFAULT_MAX_SPANS = 1 << 16


def _env_int(name: str, default: int) -> int:
    """Ring bound from the environment (PHOTON_TRACE_SPANS /
    PHOTON_FLIGHT_EVENTS, mirroring the PHOTON_TRACE switch)."""
    try:
        return max(int(os.environ.get(name, "")), 1)
    except ValueError:
        return default


# One (wall, perf) epoch per process: every span's perf_counter pair
# maps onto the wall clock through it, so cross-process traces line up
# to clock-sync accuracy without per-span time.time() calls. The fleet
# collector's NTP-style skew estimation measures a remote process's
# "now" through THIS mapping (see epoch_now), so the offset it derives
# corrects exactly the timeline the spans are exported on.
_EPOCH_WALL = time.time()  # photon: entropy(per-boot span-epoch anchor; the wall/perf pair IS the timeline contract)
_EPOCH_PERF = time.perf_counter()  # photon: entropy(per-boot span-epoch anchor; paired with _EPOCH_WALL)


def epoch() -> tuple:
    """This process's (wall, perf) epoch — the span-time -> wall-clock
    mapping, served on the wire by the ``{"op": "trace"}`` control op."""
    return (_EPOCH_WALL, _EPOCH_PERF)


def epoch_now() -> float:
    """"Now" as the span timeline sees it: the wall clock REACHED BY
    the epoch mapping (not a fresh time.time(), which may have drifted
    from it) — what the fleet collector's skew estimate must target."""
    return _EPOCH_WALL + (time.perf_counter() - _EPOCH_PERF)


# Id mints. itertools.count.__next__ is atomic (implemented in C), so
# minting needs no lock; the pid + boot-nonce prefix keeps ids unique
# across a multi-process (and multi-HOST — pids alone can collide
# across boxes) fleet whose spans are merged into one timeline.
_TRACE_IDS = itertools.count(1)
_SPAN_IDS = itertools.count(1)
_PROC_NONCE = os.urandom(3).hex()  # photon: entropy(boot nonce; id uniqueness across hosts REQUIRES per-process randomness)
_TRACE_PREFIX = f"t{os.getpid():x}.{_PROC_NONCE}-"  # photon: entropy(pid+nonce id prefix; cross-process uniqueness, not content)
_SPAN_PREFIX = f"s{os.getpid():x}.{_PROC_NONCE}-"  # photon: entropy(pid+nonce id prefix; cross-process uniqueness, not content)

# Enablement is a single module global: the disabled fast path is one
# read + branch. set_tracing is the only writer (driver startup / test
# scopes) — a torn read is impossible for a bool.
_ENABLED = os.environ.get("PHOTON_TRACE", "").strip().lower() in (
    "1", "true", "yes"
)


def tracing_enabled() -> bool:
    return _ENABLED


def set_tracing(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


@contextmanager
def tracing_scope(enabled: bool):
    """Temporarily force tracing on/off (tests, A/B benches)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    try:
        yield
    finally:
        _ENABLED = prev


def new_trace_id() -> str:
    return _TRACE_PREFIX + str(next(_TRACE_IDS))


def _new_span_id() -> str:
    return _SPAN_PREFIX + str(next(_SPAN_IDS))


class Span:
    """One timed operation. ``end()`` stamps the close time and files
    the span with its tracer — exactly once; a double end is a no-op."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "t0", "t1", "tid", "attrs", "seq", "_tracer",
    )

    def __init__(
        self,
        tracer_obj: "Tracer",
        name: str,
        trace_id: Optional[str],
        parent_id: Optional[str],
        attrs: Optional[Dict[str, object]],
        t0: Optional[float] = None,
    ):
        self.name = name
        self.trace_id = trace_id or new_trace_id()
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.t1: Optional[float] = None
        self.tid = threading.get_ident()
        self.attrs = dict(attrs) if attrs else {}
        self.seq = 0  # stamped by Tracer._file when the span is filed
        self._tracer = tracer_obj

    def end(self, t1: Optional[float] = None, **attrs) -> "Span":
        if self.t1 is not None:
            return self  # already filed
        self.t1 = time.perf_counter() if t1 is None else float(t1)
        if attrs:
            self.attrs.update(attrs)
        self._tracer._file(self)
        return self

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def to_dict(self) -> Dict[str, object]:
        # The span's wire shape — the trace-drain op ships exactly this
        # dict. The binary drain (serving/wire.py MSG_TRACE_RESPONSE)
        # relies on two invariants pinned here: ``t0``/``t1`` are the
        # ONLY float timestamp fields (they ride a raw f64 buffer,
        # everything else rides the JSON header), and ``t1`` is None
        # exactly when the span is unfinished (NaN-encoded in flight).
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t0": self.t0,
            "t1": self.t1,
            "tid": self.tid,
            "seq": self.seq,
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """The disabled path: every method a no-op, one shared instance."""

    __slots__ = ()
    name = ""
    trace_id = None
    span_id = None
    parent_id = None
    t0 = 0.0
    t1 = 0.0
    tid = 0
    seq = 0
    attrs: Dict[str, object] = {}
    duration_s = 0.0

    def end(self, t1=None, **attrs):
        return self

    def to_dict(self):
        return {}


NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded collector of finished spans.

    ``_file`` (the record side) is a lock-free ring append; the lock
    exists only for the drain/snapshot side, where it serializes the
    ring SWAP — a dump concurrent with span emission sees a consistent
    prefix, never a torn iteration (``deque`` mutation during iteration
    raises, so snapshots take the whole ring by swap instead).
    """

    def __init__(self, max_spans: Optional[int] = None):
        # ring bound: explicit arg > PHOTON_TRACE_SPANS > default. The
        # chosen bound rides every export's otherData so post-hoc drop
        # accounting is interpretable.
        self.max_spans = (
            int(max_spans)
            if max_spans is not None
            else _env_int("PHOTON_TRACE_SPANS", DEFAULT_MAX_SPANS)
        )
        # single-writer-per-append ring; appends are GIL-atomic. The
        # reference itself is swapped only under _lock (drain).
        self._ring = deque(maxlen=self.max_spans)  # photon: guarded-by(atomic)
        self._lock = threading.Lock()
        # total spans ever filed: the counter bump is C-level-atomic
        # (itertools.count), the published value a plain reference
        # assignment — drops derive as filed - retained, so a capped
        # export is visibly capped without a lock on the record path
        self._counter = itertools.count(1)  # photon: guarded-by(atomic)
        self._filed = 0  # photon: guarded-by(atomic)

    @property
    def dropped(self) -> int:
        return max(0, self._filed - len(self._ring))

    def _file(self, s: Span) -> None:
        # seq stamps a process-monotone order onto the ring so the
        # {"op": "trace"} drain can be cursor-keyed: a poll never
        # duplicates (seq > cursor filter) and never silently drops
        # (gaps in the seq line are counted eviction). Still lock-free:
        # the counter bump is C-atomic, the append GIL-atomic.
        s.seq = next(self._counter)
        self._filed = s.seq
        self._ring.append(s)

    def start(
        self,
        name: str,
        *,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attrs: Optional[Dict[str, object]] = None,
        t0: Optional[float] = None,
    ) -> Span:
        return Span(self, name, trace_id, parent_id, attrs, t0=t0)

    def record(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attrs: Optional[Dict[str, object]] = None,
    ) -> Span:
        """A span whose window already elapsed (the batcher stamps its
        dispatch window after the device section, off the locked path).
        This is the request-path fast path: the Span is assembled
        directly (no re-stamping, no attrs copy) and ring-appended —
        one object allocation plus one GIL-atomic append."""
        s = Span.__new__(Span)
        s.name = name
        s.trace_id = trace_id if trace_id is not None else new_trace_id()
        s.span_id = _new_span_id()
        s.parent_id = parent_id
        s.t0 = t0
        s.t1 = t1
        s.tid = threading.get_ident()
        s.attrs = attrs if attrs is not None else {}
        s._tracer = self
        self._file(s)
        return s

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def read_since(self, cursor: int):
        """Incremental, cursor-keyed read for the ``{"op": "trace"}``
        drain: returns ``(spans, new_cursor, dropped)`` where ``spans``
        are the finished spans with ``seq > cursor`` in a CONTIGUOUS
        seq run, ``new_cursor`` is the last returned seq (pass it back
        on the next poll), and ``dropped`` counts spans filed after the
        cursor but already evicted from the ring before this poll could
        read them.

        Two subtleties make the contract exact:

        - a span whose seq is minted but whose ring append has not yet
          landed (the record path is lock-free) would leave a MID-run
          gap; the run stops there and the next poll picks it up —
          never skipped, never duplicated;
        - a cursor AHEAD of the filed count means the ring was reset
          (drain()/clear()/process restart): the read restarts from the
          beginning rather than silently returning nothing forever.
        """
        cursor = int(cursor)
        with self._lock:
            if cursor > self._filed:
                cursor = 0
            fresh = sorted(
                (s for s in self._ring if s.seq > cursor),
                key=lambda s: s.seq,
            )
            if not fresh:
                return [], cursor, 0
            # front gap = spans evicted between polls (ring wrapped)
            dropped = fresh[0].seq - cursor - 1
            out = [fresh[0]]
            for s in fresh[1:]:
                if s.seq != out[-1].seq + 1:
                    break  # mid gap: a span is mid-file; resume next poll
                out.append(s)
            return out, out[-1].seq, max(dropped, 0)

    def drain(self) -> List[Span]:
        with self._lock:
            ring, self._ring = self._ring, deque(maxlen=self.max_spans)
            self._counter = itertools.count(1)
            self._filed = 0
            return list(ring)

    def clear(self) -> None:
        with self._lock:
            self._ring = deque(maxlen=self.max_spans)
            self._counter = itertools.count(1)
            self._filed = 0

    def __len__(self) -> int:
        return len(self._ring)


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-wide tracer every instrumentation site files into."""
    return _TRACER


def reset_tracer() -> Tracer:
    """Fresh process-wide tracer, re-reading PHOTON_TRACE_SPANS (tests
    / driver re-entry). Spans already handed out keep filing into the
    old ring — a reset mid-traffic loses them, so call it quiescent."""
    global _TRACER
    _TRACER = Tracer()
    return _TRACER


def start_span(
    name: str,
    *,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    **attrs,
):
    """Open a span on the process tracer (no-op singleton when tracing
    is off — the call sites never branch themselves). Assembled
    directly: the ``**attrs`` dict is freshly built for this call, so
    the span owns it without the defensive copy ``Span.__init__``
    makes — this is the request-path open (router request/sub-request,
    frontend request)."""
    if not _ENABLED:
        return NULL_SPAN
    s = Span.__new__(Span)
    s.name = name
    s.trace_id = trace_id if trace_id is not None else new_trace_id()
    s.span_id = _new_span_id()
    s.parent_id = parent_id
    s.t0 = time.perf_counter()
    s.t1 = None
    s.tid = threading.get_ident()
    s.attrs = attrs
    s.seq = 0
    s._tracer = _TRACER
    return s


def record_span(
    name: str,
    t0: float,
    t1: float,
    *,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    **attrs,
) -> None:
    if not _ENABLED:
        return
    _TRACER.record(
        name, t0, t1,
        trace_id=trace_id, parent_id=parent_id, attrs=attrs or None,
    )


@contextmanager
def span(
    name: str,
    *,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    **attrs,
):
    """``with span("cd.iteration", iteration=3):`` — times the block.
    Yields the open span so callers can attach result attrs."""
    s = start_span(name, trace_id=trace_id, parent_id=parent_id, **attrs)
    try:
        yield s
    finally:
        s.end()


def traced(name: str, **span_attrs):
    """Decorator: the whole call becomes one span (streaming scan/stage
    passes and other coarse phases). Zero overhead when tracing is off
    beyond one flag read."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ENABLED:
                return fn(*args, **kwargs)
            with span(name, **span_attrs):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def wire_context(record: Mapping) -> tuple:
    """(trace_id, parent_span_id) carried on a wire request, or
    (None, None) — the frontend mints a fresh trace for bare requests."""
    t = record.get(TRACE_KEY)
    p = record.get(PARENT_KEY)
    return (None if t is None else str(t), None if p is None else str(p))


# The dispatch hot path records ONE span per batch; the per-request
# leaves are synthesized from this attr at export time (constant work
# per dispatch on the request path, per-request work only when someone
# actually looks at the trace).
TRACES_ATTR = "traces"


def expand_spans(spans: Iterable[Span]) -> List[Span]:
    """Materialize per-request child spans from batch-level spans.

    A span carrying ``attrs[TRACES_ATTR] = [(trace_id, parent_span,
    degraded), ...]`` (the batcher's dispatch span) expands into one
    ``serving.score`` child per entry, sharing the batch's dispatch
    window and parented under each request's own wire span — the leaf
    that connects a routed request's trace to the device dispatch that
    served it. Returns originals + synthesized children; the originals'
    attrs are untouched."""
    out: List[Span] = []
    for s in spans:
        out.append(s)
        traces = s.attrs.get(TRACES_ATTR) if s.attrs else None
        if not traces:
            continue
        for entry in traces:
            trace_id, parent_id, degraded = entry
            child = Span.__new__(Span)
            child.name = "serving.score"
            child.trace_id = trace_id
            child.span_id = _new_span_id()
            child.parent_id = parent_id
            child.t0 = s.t0
            child.t1 = s.t1
            child.tid = s.tid
            child.seq = s.seq
            child.attrs = {
                "degraded": bool(degraded),
                "dispatch_span": s.span_id,
                **{
                    k: v for k, v in s.attrs.items()
                    if k in ("generation", "shape")
                },
            }
            child._tracer = s._tracer
            out.append(child)
    return out


# -- export -------------------------------------------------------------------


def _wall_us(perf_t: float) -> float:
    return (_EPOCH_WALL + (perf_t - _EPOCH_PERF)) * 1e6


def chrome_trace_events(spans: Iterable[Span]) -> List[Dict[str, object]]:
    """Chrome trace-event "complete" (``ph: "X"``) records: what
    Perfetto and chrome://tracing load, and the same container the
    ``torch.profiler`` device trace exports to — host spans and device
    timelines open side by side. Batch-level spans expand into their
    per-request leaves here (see :func:`expand_spans`)."""
    pid = os.getpid()
    out: List[Dict[str, object]] = []
    for s in expand_spans(spans):
        if s.t1 is None:
            continue
        args: Dict[str, object] = {
            "trace_id": s.trace_id,
            "span_id": s.span_id,
        }
        if s.parent_id is not None:
            args["parent_span"] = s.parent_id
        for k, v in s.attrs.items():
            if k == TRACES_ATTR:
                args["traced_requests"] = len(v)
                continue
            args[k] = v if isinstance(v, (int, float, bool, str)) else str(v)
        out.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "ts": _wall_us(s.t0),
            "dur": max((s.t1 - s.t0) * 1e6, 0.001),
            "pid": pid,
            "tid": s.tid,
            "args": args,
        })
    return out


def export_chrome_trace(  # photon: entropy(trace artifact; pid + boot epoch attribute the timeline to its process by design)
    path: str,
    spans: Optional[Iterable[Span]] = None,
    *,
    extra: Optional[Dict[str, object]] = None,
) -> int:
    """Atomically write the spans (default: the process tracer's current
    ring) as one Chrome trace-event JSON file. Returns the event count."""
    from photon_ml_tpu_torch.reliability import atomic_write_json

    spans = _TRACER.snapshot() if spans is None else list(spans)
    events = chrome_trace_events(spans)
    payload: Dict[str, object] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "pid": os.getpid(),
            "dropped_spans": _TRACER.dropped,
            # the configured ring bound (PHOTON_TRACE_SPANS) rides the
            # artifact so drop accounting is interpretable post-hoc
            "max_spans": _TRACER.max_spans,
            "epoch_wall": _EPOCH_WALL,
            "epoch_perf": _EPOCH_PERF,
            **(extra or {}),
        },
    }
    atomic_write_json(path, payload)
    return len(events)
