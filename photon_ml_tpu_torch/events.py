"""Re-export: the typed training events and their emitter live in the
telemetry plane as :mod:`photon_ml_tpu_torch.obs.events`, where
``EventEmitter.send`` also files every event into the process flight
recorder (as ``photon_ml_tpu/events.py`` re-exports its
``obs/events.py``). Emit sites and tests import from here unchanged."""

from photon_ml_tpu_torch.obs.events import (  # noqa: F401
    Event,
    EventEmitter,
    EventListener,
    PhotonOptimizationLogEvent,
    PhotonSetupEvent,
    ScheduleCacheEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)

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
