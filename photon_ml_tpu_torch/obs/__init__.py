"""Host-side telemetry for the serving path (port of the tracing and
flight-recorder parts of ``photon_ml_tpu/obs``): request spans with wire
propagation (:mod:`.trace`) and the bounded event ring with its
conservation counters (:mod:`.flight_recorder`). Tracing is off unless
asked for. ``ObsSession``, the metrics registry, SLOs and the fleet
collector are ROADMAP item 15.
"""

from photon_ml_tpu_torch.obs.flight_recorder import (  # noqa: F401
    FlightRecorder,
    flight_recorder,
)
from photon_ml_tpu_torch.obs.trace import (  # noqa: F401
    record_span,
    set_tracing,
    start_span,
    tracer,
    tracing_enabled,
    tracing_scope,
)
