"""Typed structured events and their emitter (port of
``photon_ml_tpu/obs/events.py``, which ``photon_ml_tpu/events.py``
re-exports). The reference also files every event into its flight
recorder; that hook comes with the port of ``obs/`` (ROADMAP item 15).

Reference: photon-ml .../event/Event.scala:27-64, EventEmitter.scala:88-130,
EventListener.scala; listeners injected by class name via
``--event-listeners`` (Driver.scala:110-119).
"""

from __future__ import annotations

import importlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List


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
    (``ops/schedule_cache.py``)."""

    stats: Dict[str, float] = field(default_factory=dict)


class EventListener:
    def on_event(self, event: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class EventEmitter:
    """Thread-safe fan-out of events to registered listeners."""

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
