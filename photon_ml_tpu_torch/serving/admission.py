"""Admission control for the request path: named terminal outcomes,
deadline bookkeeping, and the queue-wait predictor behind load shedding
(a copy of ``photon_ml_tpu/serving/admission.py``, which imports nothing
of JAX).

The overload-control contract (the Orca-style continuous-batching
schedulers, PAPERS.md): a serving loop that is past capacity must say
"no" QUICKLY and KEEP its latency promise to the requests it admits —
an unbounded queue converts overload into unbounded p99 for everyone.
Three mechanisms, all host-side and allocation-free on the hot path:

- **Deadlines.** Every request may carry a client-propagated
  ``deadline_ms`` (milliseconds from enqueue). A request whose deadline
  passes while queued is dropped *before* dispatch — the device never
  scores dead work — and its future fails with
  :class:`DeadlineExceeded`.
- **Shedding.** ``MicroBatcher.submit`` consults
  :class:`AdmissionController` — an EWMA model of per-row service time
  — and refuses immediately (:class:`RequestShed`) when the predicted
  queue wait already exceeds the request's deadline. A full queue
  blocks only for the request's own remaining budget, never forever.
- **Named outcomes.** Every accepted request reaches EXACTLY ONE
  terminal state: a result, or one of the :class:`ServingError`
  subclasses below, each carrying a stable ``code`` the front-end maps
  onto the wire. Nothing on the request path hangs, and nothing fails
  anonymously.

:class:`ScoreOutcome` is a ``float`` subclass so existing callers (and
the bitwise parity tests) keep comparing scores as plain numbers while
the front-end reads the ``degraded``/``generation`` annotations off the
same object.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "ServingError",
    "RequestShed",
    "DeadlineExceeded",
    "DrainTimeout",
    "BatcherClosed",
    "NoShardAvailable",
    "ScoreOutcome",
    "PartialScore",
    "AdmissionController",
]


class ServingError(RuntimeError):
    """Base of the request path's named terminal failures. ``code`` is
    the stable wire-level identifier (the front-end's ``error`` field
    and the metrics outcome key) — messages are for humans, codes are
    the contract."""

    code = "INTERNAL"

    def __init__(self, message: str):
        super().__init__(message)


class RequestShed(ServingError):
    """Admission refused the request up front: the predicted queue wait
    (or a bounded full-queue wait) already exceeds its deadline. Shed
    requests never occupy a queue slot past their budget and never reach
    the device. ``reason`` is the metrics key (``predicted_wait`` /
    ``queue_full``) — carried on the exception so the accounting can
    happen OUTSIDE the queue lock (PL010 atomicity-hygiene: no foreign
    critical section inside the Condition-backed submit lock)."""

    code = "SHED"

    def __init__(self, message: str, *, reason: str = "shed"):
        super().__init__(message)
        self.reason = reason


class DeadlineExceeded(ServingError):
    """The request's deadline passed while it sat in the queue; it was
    dropped before dispatch so the device never scored dead work."""

    code = "DEADLINE_EXCEEDED"


class DrainTimeout(ServingError):
    """The batcher was asked to drain and this request was still
    pending when the drain budget ran out. The named leftover-failure
    of the SIGTERM path — never a hung future."""

    code = "DRAIN_TIMEOUT"


class BatcherClosed(ServingError):
    """Submitted to a closed (or draining) batcher."""

    code = "CLOSED"


class NoShardAvailable(ServingError):
    """The routing tier could not reach ANY healthy shard-server for
    the fixed-effect half of a request — degradation needs at least one
    live shard to compute the FE score, so this is the router's only
    hard failure (one dead shard degrades, ALL dead shards refuse)."""

    code = "NO_SHARD"


class ScoreOutcome(float):
    """A score that is still a ``float`` (bitwise comparisons, numpy
    coercion and the existing parity tests all work unchanged) but
    carries the response annotations the front-end needs:

    - ``degraded`` — True when one or more random-effect coordinates
      could not be resolved (quarantined bank or a failed row lookup)
      and the request was scored FE-only instead of failed;
    - ``generation`` — the model-bank generation the batch ran on.
    """

    __slots__ = ("degraded", "generation")

    def __new__(
        cls, value: float, *, degraded: bool = False, generation: int = 0
    ) -> "ScoreOutcome":
        self = super().__new__(cls, value)
        self.degraded = bool(degraded)
        self.generation = int(generation)
        return self

    def __repr__(self) -> str:  # float repr + the annotations
        return (
            f"ScoreOutcome({float(self)!r}, degraded={self.degraded}, "
            f"generation={self.generation})"
        )


class PartialScore:
    """One shard-server's half of a routed score: the fixed-effect
    accumulation (every shard holds the full FE banks, so any shard can
    produce it — bitwise identical across shards) plus this shard's
    per-coordinate random-effect/MF terms, each an IEEE float32 the
    router re-sums in spec order. ``terms`` maps coordinate NAME ->
    term value; a coordinate whose entity this shard does not own (or
    the model does not know) contributes exactly ``0.0`` — the same
    zero the single-server program adds, which is what makes the
    routed recomposition bitwise-equal to the unrouted path.

    Immutable value object; the shard-mode batcher resolves futures
    with these instead of :class:`ScoreOutcome`. Two storage forms, one
    contract: the dict form (``__init__``) and the vectorized form
    (:meth:`from_vector` — name tuple + f32 vector straight out of the
    dispatch's gathered terms, no per-float dict build on the hot
    path). ``terms`` materializes the dict lazily; the binary wire's
    single-pass encoder reads :meth:`term_vector` and never pays for
    the dict at all.
    """

    __slots__ = ("fe", "offset", "degraded", "generation",
                 "_terms", "_names", "_vec")

    def __init__(
        self,
        fe: float,
        terms,
        *,
        offset: float = 0.0,
        degraded: bool = False,
        generation: int = 0,
    ):
        self.fe = float(fe)
        self._terms: Optional[dict] = dict(terms)
        self._names = None
        self._vec = None
        self.offset = float(offset)
        self.degraded = bool(degraded)
        self.generation = int(generation)

    @classmethod
    def from_vector(
        cls,
        fe: float,
        names,
        vec,
        *,
        offset: float = 0.0,
        degraded: bool = False,
        generation: int = 0,
    ) -> "PartialScore":
        """Build from the dispatcher's per-request term row: ``names``
        in spec order, ``vec`` the matching f32 values. O(1) — the
        vector is referenced, not copied, and no dict is built."""
        self = cls.__new__(cls)
        self.fe = float(fe)
        self._terms = None
        self._names = tuple(names)
        self._vec = np.asarray(vec, dtype=np.float32)
        self.offset = float(offset)
        self.degraded = bool(degraded)
        self.generation = int(generation)
        return self

    @property
    def terms(self) -> dict:
        """NAME -> float term value (exact f64 of each f32, identical
        to what the JSON wire round-trips). Materialized once on first
        access for vector-form instances."""
        t = self._terms
        if t is None:
            t = dict(zip(self._names, self._vec.tolist()))
            self._terms = t
        return t

    def term_vector(self):
        """``(names, f32 vector)`` in a stable order — the binary
        wire's single-copy encode source. Dict-form instances pay the
        conversion once, here, instead of per encode."""
        if self._names is None:
            names = tuple(self._terms)
            self._vec = np.fromiter(
                (self._terms[n] for n in names),
                dtype=np.float32,
                count=len(names),
            )
            self._names = names
        return self._names, self._vec

    def __repr__(self) -> str:
        return (
            f"PartialScore(fe={self.fe!r}, terms={self.terms!r}, "
            f"offset={self.offset!r}, degraded={self.degraded}, "
            f"generation={self.generation})"
        )


class AdmissionController:
    """EWMA service-time model -> predicted queue wait.

    ``note_dispatch`` feeds it one (rows, busy seconds) observation per
    dispatched micro-batch; ``predicted_wait_s(queue_len)`` is the
    expected time a request joining the back of the queue waits before
    its own dispatch starts. Deliberately simple and conservative:

    - per-ROW time (busy_s / rows) already amortizes batching, so the
      prediction scales with queue DEPTH, not dispatch count;
    - cold start (no observations yet) predicts 0 — admit everything
      until there is evidence of cost, so an idle service never sheds
      its first request;
    - the EWMA (default ``alpha=0.2``) tracks shape changes (a hot swap
      to a bigger model, a ladder rung change) within a few dispatches
      without oscillating on scheduler noise.
    """

    def __init__(self, alpha: float = 0.2):
        self._alpha = float(alpha)
        # single-writer atomic publish: only the dispatcher thread
        # writes (one plain reference assignment per dispatch), and
        # submit-side readers take a snapshot — so predicted_wait_s is
        # LOCK-FREE and safe to call inside the batcher's queue lock
        # (no foreign critical section under the Condition-backed lock,
        # PL010)
        self._per_row_s: Optional[float] = None  # photon: guarded-by(atomic)

    def note_dispatch(self, rows: int, busy_s: float) -> None:
        per_row = max(busy_s, 0.0) / max(int(rows), 1)
        cur = self._per_row_s
        self._per_row_s = (
            per_row if cur is None
            else cur + self._alpha * (per_row - cur)
        )

    def per_row_s(self) -> float:
        return self._per_row_s or 0.0

    def predicted_wait_s(self, queue_len: int) -> float:
        cur = self._per_row_s
        if cur is None:
            return 0.0
        return max(int(queue_len), 0) * cur
