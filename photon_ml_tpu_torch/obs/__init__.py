"""Unified telemetry plane (port of ``photon_ml_tpu/obs``): request and
training tracing, a process-wide metrics registry with live wire
exposition, and the crash/rollback flight recorder.

Four pieces, all host arithmetic (obs code never touches a device
tensor):

- :mod:`photon_ml_tpu_torch.obs.trace` — lightweight spans with trace
  ids minted at the frontend, carried on the wire, propagated through
  router -> shard -> batcher dispatch and the training loops; exported
  as Chrome trace-event JSON next to the ``torch.profiler`` device
  traces of ``--profile-dir`` (:mod:`photon_ml_tpu_torch.utils.profiling`).
- :mod:`photon_ml_tpu_torch.obs.registry` — counters/gauges/bounded
  histograms with capped label cardinality, plus views over the
  existing subsystem accumulators (ServingMetrics, RouterMetrics, host
  timings, reliability accounting); served live by the frontend's
  ``{"op": "metrics"}`` and snapshotted periodically under
  ``--obs-dir``.
- :mod:`photon_ml_tpu_torch.obs.flight_recorder` — a bounded ring of
  structured protocol events (swap/rollback/shed/circuit/fault) with
  monotone conservation counters and atomic dumps on SIGTERM, rollback,
  and operator request; ``check_conservation()`` is the
  every-request-reaches-a-named-outcome invariant.
- :mod:`photon_ml_tpu_torch.obs.events` — the typed-event emitter (ONE
  structured-event path; ``photon_ml_tpu_torch.events`` re-exports it).

:class:`ObsSession` is the drivers' one-call wiring: ``--obs-dir``
enables tracing, arms the flight recorder's auto-dump, starts the
periodic snapshot writer, and ``finish()`` exports ``trace.json`` +
``flight.json`` + the final snapshot.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

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
from photon_ml_tpu_torch.obs.flight_recorder import (  # noqa: F401
    FlightRecorder,
    flight_recorder,
    install_signal_dump,
    reset_flight_recorder,
)
from photon_ml_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SnapshotWriter,
    default_registry,
    reset_default_registry,
)
from photon_ml_tpu_torch.obs.trace import (  # noqa: F401
    PARENT_KEY,
    TRACE_KEY,
    Span,
    Tracer,
    chrome_trace_events,
    epoch,
    epoch_now,
    export_chrome_trace,
    new_trace_id,
    record_span,
    reset_tracer,
    set_tracing,
    span,
    start_span,
    tracer,
    tracing_enabled,
    tracing_scope,
    wire_context,
)

# Fleet-scale observability: imported lazily by consumers —
# photon_ml_tpu_torch.obs.fleet (FleetCollector, stitch/verify/export,
# fleet_check_conservation, the post-hoc CLI) and photon_ml_tpu_torch.obs.slo
# (SLOSpec, SLOEngine, parse_slo_specs) are deliberately NOT imported
# here: the serving hot path imports this package and must not pay for
# the collector/engine machinery it never uses.

__all__ = ["ObsSession"]


class ObsSession:
    """Driver-side wiring for ``--obs-dir``: one constructor call at
    startup, one ``finish()`` at exit.

    On construction (when ``obs_dir`` is set): tracing flips on, the
    process flight recorder arms its transition auto-dump at
    ``<obs_dir>/flight.json``, standard process views (host timings,
    reliability accounting, readback count, flight counters) register
    with the process registry, and the periodic snapshot writer starts.
    ``finish()`` stops the writer (final snapshot included), exports
    the span ring as Chrome trace-event JSON, and dumps the flight ring
    — all through atomic writers. A driver without ``--obs-dir``
    constructs this with ``obs_dir=None`` and every method no-ops.
    """

    def __init__(
        self,
        obs_dir: Optional[str],
        *,
        snapshot_period_s: float = 5.0,
        signal_dump: bool = True,
        extra_views: Optional[Dict[str, object]] = None,
    ):
        self.obs_dir = obs_dir or None
        self.registry: Optional[MetricsRegistry] = None
        self.recorder: Optional[FlightRecorder] = None
        self._writer: Optional[SnapshotWriter] = None
        self._finished = False
        if self.obs_dir is None:
            return
        os.makedirs(self.obs_dir, exist_ok=True)
        set_tracing(True)
        self.recorder = flight_recorder()
        self.recorder.set_auto_dump(self.flight_path)
        if signal_dump:
            install_signal_dump(self.flight_path)
        self.registry = default_registry()
        self._register_process_views()
        for name, fn in (extra_views or {}).items():
            self.registry.register_view(name, fn)
        self._writer = SnapshotWriter(
            self.registry, self.obs_dir, period_s=snapshot_period_s
        ).start()

    @property
    def enabled(self) -> bool:
        return self.obs_dir is not None

    @property
    def flight_path(self) -> str:
        return os.path.join(self.obs_dir or "", "flight.json")

    @property
    def trace_path(self) -> str:
        return os.path.join(self.obs_dir or "", "trace.json")

    def _register_process_views(self) -> None:
        from photon_ml_tpu_torch.parallel import overlap
        from photon_ml_tpu_torch.reliability import reliability_metrics
        from photon_ml_tpu_torch.utils.profiling import host_timings

        reg = self.registry
        reg.register_view("host_timings", host_timings)
        reg.register_view("reliability", reliability_metrics)
        reg.register_view(
            "readbacks", lambda: {"device_get_calls": overlap.readback_stats()}
        )
        rec = self.recorder
        reg.register_view(
            "flight",
            lambda: {
                "recorded": rec.snapshot()["recorded"],
                "conservation": rec.check_conservation(),
            },
        )

    def register_view(self, name: str, fn) -> None:
        if self.registry is not None:
            self.registry.register_view(name, fn)

    def record(self, kind: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.record(kind, **fields)

    def finish(self, *, reason: str = "exit") -> Optional[Dict[str, object]]:
        """Flush everything; idempotent. Returns a summary block for
        metrics.json (paths + conservation verdict) or None when
        disabled."""
        if self.obs_dir is None or self._finished:
            return None
        self._finished = True
        if self._writer is not None:
            self._writer.stop()
        n_spans = export_chrome_trace(self.trace_path)
        self.recorder.dump(self.flight_path, reason=reason)
        conservation = self.recorder.check_conservation()
        return {
            "obs_dir": self.obs_dir,
            "trace_path": self.trace_path,
            "trace_events": n_spans,
            "flight_path": self.flight_path,
            "conservation": conservation,
        }
