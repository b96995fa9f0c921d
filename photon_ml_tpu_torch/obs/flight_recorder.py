"""Crash/rollback flight recorder: a bounded ring of structured events
plus monotone conservation counters, dumped atomically on SIGTERM,
rollback, and operator request (a copy of
``photon_ml_tpu/obs/flight_recorder.py``, retargeted at the port's
atomic writer).

When a serving replica rolls back (or a chaos arm SIGKILLs a shard
mid-flood), the question is always "what was the exact sequence?" —
swap staged where, committed when, which circuit opened first, which
fault seam fired. ``metrics.json`` answers "how much"; the flight
recorder answers "in what order": every structured event carries a
process-monotone sequence number and a wall timestamp, the ring is
bounded (old events fall off; the counters do not), and dumps go
through the reliability layer's atomic writer so a dump racing a crash
leaves the previous complete file, never a torn one.

Event sources (each a one-line hook at the subsystem):

- ``swap.stage`` / ``swap.commit`` / ``swap.abort`` / ``swap.rollback``
  — the serving generation protocol (``serving/swap.py``);
- ``watcher.rollback`` / ``watcher.promote`` — registry-driven swaps;
- ``request.shed`` / ``request.deadline`` — overload outcomes;
- ``circuit.open`` / ``circuit.close`` — router shard breakers;
- ``fault.crossing`` — every TRIGGERED injection at a reliability seam;
- ``registry.lease`` / ``registry.publish`` — publication transitions;

**Conservation.** The recorder also keeps monotone counters fed by the
micro-batcher: ``admitted`` (requests that entered the queue) and
``terminal[outcome]`` (every future resolution, keyed by outcome name
and by the generation that served it). :meth:`check_conservation` is
the end-to-end invariant the ROADMAP's scenario-factory item names —
*every admitted request reaches exactly one named terminal outcome,
conserved across generation swaps* — and the chaos arms call it at
every quiescent point. Counter feeds happen on the submit/resolve
paths (which already take the metrics lock today), never inside the
batcher's locked device section, so the 1-readback / 0-lowering /
no-new-hot-path-locks contract is untouched.

Host arithmetic only: nothing in obs/ touches a device tensor.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "flight_recorder",
    "reset_flight_recorder",
    "install_signal_dump",
]

DEFAULT_CAPACITY = 4096


def _env_capacity() -> int:
    """Ring bound from PHOTON_FLIGHT_EVENTS (mirroring PHOTON_TRACE /
    PHOTON_TRACE_SPANS); the chosen bound rides every snapshot/dump as
    ``capacity`` so drop accounting is interpretable post-hoc."""
    try:
        return max(int(os.environ.get("PHOTON_FLIGHT_EVENTS", "")), 1)
    except ValueError:
        return DEFAULT_CAPACITY

# Event kinds whose arrival auto-dumps the ring when an auto-dump path
# is armed: low-frequency protocol transitions. A SIGKILLed process
# cannot run an exit handler, but its last swap/rollback transition
# already persisted the ring — which is exactly what the post-mortem
# needs.
AUTO_DUMP_KINDS = (
    "swap.", "watcher.", "registry.", "rollback", "fault.",
)


class FlightRecorder:
    """Bounded structured-event ring + conservation counters. One
    instance per process (module singleton below); every method is
    thread-safe under the recorder's single lock — including dumps, so
    a dump concurrent with event emission is never torn."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = (
            int(capacity) if capacity is not None else _env_capacity()
        )
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0  # photon: guarded-by(_lock)
        self._recorded = 0  # photon: guarded-by(_lock)
        self._admitted = 0  # photon: guarded-by(_lock)
        self._terminal: Dict[str, int] = {}  # photon: guarded-by(_lock)
        self._terminal_by_gen: Dict[str, int] = {}  # photon: guarded-by(_lock)
        self._terminal_by_attr: Dict[str, int] = {}  # photon: guarded-by(_lock)
        self._auto_dump_path: Optional[str] = None  # photon: guarded-by(_lock)
        self._dumps = 0  # photon: guarded-by(_lock)
        self._dump_errors = 0  # photon: guarded-by(_lock)

    # -- event side -----------------------------------------------------------

    def record(self, kind: str, **fields) -> int:
        """File one structured event; returns its sequence number.
        Fields must be JSON-representable scalars/containers (enforced
        at dump time via ``default=str`` — a bad field degrades to its
        repr, never a lost dump)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._recorded += 1
            self._ring.append({
                "seq": seq,
                "t": time.time(),
                "kind": str(kind),
                **({"fields": fields} if fields else {}),
            })
            auto = self._auto_dump_path
        if auto is not None and any(
            str(kind).startswith(p) for p in AUTO_DUMP_KINDS
        ):
            self.dump(auto)
        return seq

    def events(self, kind_prefix: str = "") -> List[Dict[str, object]]:
        with self._lock:
            evs = list(self._ring)
        if kind_prefix:
            evs = [e for e in evs if str(e["kind"]).startswith(kind_prefix)]
        return evs

    # -- conservation counters ------------------------------------------------

    def note_admitted(self, n: int = 1) -> None:
        with self._lock:
            self._admitted += int(n)

    def note_terminal(
        self,
        outcome: str,
        *,
        generation: Optional[int] = None,
        attribution: Optional[str] = None,
        n: int = 1,
    ) -> None:
        """One (or n) named terminal outcome(s). ``attribution`` is the
        fleet-conservation split: the router stamps every terminal with
        WHO terminated it (``shard:<i>`` for a wire-served gather keyed
        by the FE-providing shard, ``cache`` for a zero-fan-out hot-
        cache hit, ``degraded`` for FE-only outcomes, ``no_shard`` /
        ``shed`` for refusals), so fleet_check_conservation can balance
        router admitted == Σ shard-attributed + router-local books."""
        with self._lock:
            self._terminal[outcome] = self._terminal.get(outcome, 0) + int(n)
            gen_key = "none" if generation is None else str(generation)
            self._terminal_by_gen[gen_key] = (
                self._terminal_by_gen.get(gen_key, 0) + int(n)
            )
            if attribution is not None:
                self._terminal_by_attr[attribution] = (
                    self._terminal_by_attr.get(attribution, 0) + int(n)
                )

    def check_conservation(self) -> Dict[str, object]:
        """``admitted == sum(terminal outcomes)`` — SLO accounting
        conserved across swaps (the per-generation split must re-sum to
        the same total). ``in_flight`` is the difference; the invariant
        holds at any quiescent point (drained batcher, completed
        flood), so chaos arms assert ``ok`` there."""
        with self._lock:
            terminal_total = sum(self._terminal.values())
            by_gen_total = sum(self._terminal_by_gen.values())
            return {
                "ok": (
                    self._admitted == terminal_total
                    and by_gen_total == terminal_total
                ),
                "admitted": self._admitted,
                "terminal_total": terminal_total,
                "in_flight": self._admitted - terminal_total,
                "terminal": dict(sorted(self._terminal.items())),
                "terminal_by_generation": dict(
                    sorted(self._terminal_by_gen.items())
                ),
                "terminal_by_attribution": dict(
                    sorted(self._terminal_by_attr.items())
                ),
            }

    # -- dumps ----------------------------------------------------------------

    def set_auto_dump(self, path: Optional[str]) -> None:
        """Arm (or disarm with None) dump-on-transition: every
        swap/rollback/registry event persists the ring to ``path``, so
        even a SIGKILLed process leaves its last protocol transition on
        disk. The SIGTERM path dumps via :func:`install_signal_dump`."""
        with self._lock:
            self._auto_dump_path = path

    def snapshot(self) -> Dict[str, object]:  # photon: entropy(live telemetry snapshot; pid attributes the dump to its process)
        with self._lock:
            return {
                "pid": os.getpid(),
                "capacity": self.capacity,
                "recorded": self._recorded,
                "retained": len(self._ring),
                "dropped": self._recorded - len(self._ring),
                "events": list(self._ring),
                "dumps": self._dumps,
                "dump_errors": self._dump_errors,
            }

    def dump(self, path: str, *, reason: str = "") -> Optional[str]:
        """Atomically persist ring + counters + conservation verdict.
        Returns the path, or None when the write failed (counted — the
        recorder must never take down the process it records)."""
        import json

        from photon_ml_tpu_torch.reliability import atomic_write_text

        payload = {
            **self.snapshot(),
            "reason": reason,
            "conservation": self.check_conservation(),
        }
        try:
            # default=str: a non-JSON event field degrades to its repr,
            # never a lost dump
            atomic_write_text(
                path, json.dumps(payload, indent=2, default=str)
            )
        except OSError:
            with self._lock:
                self._dump_errors += 1
            return None
        with self._lock:
            self._dumps += 1
        return path

    def reset(self) -> None:
        with self._lock:
            self._ring = deque(maxlen=self.capacity)
            self._seq = 0
            self._recorded = 0
            self._admitted = 0
            self._terminal = {}
            self._terminal_by_gen = {}
            self._terminal_by_attr = {}
            self._dumps = 0
            self._dump_errors = 0


_SINGLETON_LOCK = threading.Lock()
_RECORDER: Optional[FlightRecorder] = None


def flight_recorder() -> FlightRecorder:
    """The process-wide recorder every hook files into."""
    global _RECORDER
    with _SINGLETON_LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def reset_flight_recorder(
    capacity: Optional[int] = None,
) -> FlightRecorder:
    """Fresh process-wide recorder (tests / driver re-entry); the
    default capacity re-reads PHOTON_FLIGHT_EVENTS."""
    global _RECORDER
    with _SINGLETON_LOCK:
        _RECORDER = FlightRecorder(capacity)
        return _RECORDER


def install_signal_dump(
    path: str, signals=(signal.SIGTERM,)
) -> None:
    """Chain a flight-recorder dump onto the given signals' existing
    handlers (main thread only; a non-main-thread caller is a no-op —
    the driver's own drain path still dumps explicitly). The previous
    handler runs AFTER the dump, so the drain protocol is unchanged."""
    rec = flight_recorder()
    for sig in signals:
        try:
            prev = signal.getsignal(sig)
        except (ValueError, OSError):
            continue

        def _handler(signum, frame, _prev=prev):
            rec.record("signal", signum=signum)
            rec.dump(path, reason=f"signal {signum}")
            if callable(_prev):
                _prev(signum, frame)
            elif _prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        try:
            signal.signal(sig, _handler)
        except ValueError:
            return  # not the main thread
