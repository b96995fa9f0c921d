"""Typed structured events + emitter — the ONE structured-event path
(a copy of ``photon_ml_tpu/obs/events.py``).

The typed events (the reference's
EventEmitter.scala shape: typed events, registered listeners,
synchronized fan-out) folded into the obs plane: every ``send`` now
ALSO files the event into the process flight recorder as
``event.<ClassName>``, so driver-level lifecycle events (setup,
training start/finish, per-λ optimization logs, schedule-cache stats)
land on the same ordered timeline as swap/rollback/fault transitions
instead of living in a parallel, listener-only world.

``photon_ml_tpu_torch.events`` is a thin re-export of everything here —
existing emit sites import from there unchanged.

Reference: photon-ml .../event/Event.scala:27-64,
EventEmitter.scala:88-130, EventListener.scala; listeners injected by
class name via ``--event-listeners`` (Driver.scala:110-119).
"""

from __future__ import annotations

import importlib
import threading
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List

__all__ = [
    "Event",
    "PhotonSetupEvent",
    "TrainingStartEvent",
    "TrainingFinishEvent",
    "PhotonOptimizationLogEvent",
    "ScheduleCacheEvent",
    "EventListener",
    "EventEmitter",
]


@dataclass(frozen=True)
class Event:
    pass


@dataclass(frozen=True)
class PhotonSetupEvent(Event):
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class TrainingStartEvent(Event):
    job_name: str = ""


@dataclass(frozen=True)
class TrainingFinishEvent(Event):
    job_name: str = ""


@dataclass(frozen=True)
class PhotonOptimizationLogEvent(Event):
    reg_weight: float = 0.0
    iterations: int = 0
    convergence_reason: str = ""
    final_value: float = 0.0
    metrics: Dict[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class ScheduleCacheEvent(Event):
    """Tile-schedule cache outcome for one training stage: hit/miss/build
    counters plus the host-side build/load/store timers
    (ops/schedule_cache.py). Emitted by the drivers after training so
    listeners can track cold-vs-warm schedule cost per run."""

    stats: Dict[str, float] = field(default_factory=dict)


class EventListener:
    def on_event(self, event: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


def _event_fields(event: Event) -> Dict[str, object]:
    """Shallow field view for the flight-recorder record: scalars pass
    through, containers degrade to their repr at dump time (the
    recorder dumps with ``default=str``)."""
    if not is_dataclass(event):
        return {}
    return {f.name: getattr(event, f.name) for f in fields(event)}


class EventEmitter:
    """Thread-safe fan-out of events to registered listeners, with the
    flight recorder as the always-on structural listener."""

    def __init__(self):
        self._listeners: List[EventListener] = []
        self._lock = threading.Lock()

    def register(self, listener: EventListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def register_by_name(self, class_path: str) -> None:
        """Instantiate `pkg.module.Class` by name (--event-listeners)."""
        module_name, _, cls_name = class_path.rpartition(".")
        cls = getattr(importlib.import_module(module_name), cls_name)
        self.register(cls())

    def send(self, event: Event) -> None:
        from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder

        flight_recorder().record(
            f"event.{type(event).__name__}", **_event_fields(event)
        )
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            listener.on_event(event)

    def close(self) -> None:
        with self._lock:
            listeners = list(self._listeners)
            self._listeners.clear()
        for listener in listeners:
            listener.close()
