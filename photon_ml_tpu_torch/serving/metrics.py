"""Serving-side observability: latency percentiles, QPS, batch
occupancy, pad waste, swap/compile accounting (a copy of
``photon_ml_tpu/serving/metrics.py``, retargeted at the port's
reliability layer).

Everything here is host arithmetic over host timestamps — nothing in
this module may touch a device value (the request path's readback
budget is exactly one ``overlap.device_get`` per dispatch, owned by the
batcher). Latencies keep a bounded reservoir: full fidelity up to the
cap, then uniform-by-stride thinning so a week of traffic cannot grow
host memory — percentiles stay estimates over a deterministic subset,
never a stopped service.

``snapshot()`` is the metrics.json block; the driver merges it with the
reliability accounting (faults/retries/quarantines) so one artifact
answers both "how fast" and "what broke".
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ServingMetrics"]


class ServingMetrics:
    """Thread-safe accumulator shared by the batcher, the front-end,
    the swap path and the driver."""

    def __init__(self, *, max_latency_samples: int = 1 << 20):
        self._lock = threading.Lock()
        self._max_samples = int(max_latency_samples)
        self._lat: List[float] = []
        self._stride = 1
        self._seen = 0
        self._dispatches = 0
        self._rows_real = 0
        self._rows_padded = 0
        self._queue_wait_s = 0.0
        self._device_s = 0.0
        self._shape_counts: Dict[int, int] = {}
        self._gen_dispatches: Dict[int, int] = {}
        self._first_t: Optional[float] = None
        self._last_t: Optional[float] = None
        # overload/degradation/lifecycle accounting: sheds by
        # reason, deadline drops, degraded (FE-only) responses, RE
        # lookup failures/quarantines, front-end line/connection
        # counters, and the drain report. All host counters — the
        # one-readback-per-dispatch budget is untouched.
        self._sheds: Dict[str, int] = {}
        self._deadline_expired = 0
        self._degraded = 0
        self._re_resolution_failures: Dict[str, int] = {}
        self._re_quarantines: Dict[str, int] = {}
        self._frontend: Dict[str, int] = {}
        self._responses: Dict[str, int] = {}
        self._drain: Optional[Dict[str, object]] = None
        # live registry mirrors (SLO-engine inputs, obs/slo.py): bound
        # once by bind_registry before traffic, read bare on the record
        # paths — single-writer plain-reference publishes
        self._reg_total = None  # photon: guarded-by(atomic)
        self._reg_bad = None  # photon: guarded-by(atomic)
        self._reg_latency = None  # photon: guarded-by(atomic)

    def bind_registry(self, registry, *, prefix: str = "serving") -> None:
        """Mirror the request-path outcomes into live registry
        instruments: ``<prefix>_requests_total`` (every request that
        reached a terminal), ``<prefix>_bad_total`` (shed / deadline /
        degraded — the error-budget burners, labelled by reason) and
        the ``<prefix>_latency_seconds`` histogram. These are what
        declarative SLO specs (obs/slo.py) evaluate over; the mirrors
        feed OUTSIDE this accumulator's lock, so the request path gains
        one instrument-local lock per event and no nesting."""
        self._reg_total = registry.counter(
            f"{prefix}_requests_total",
            "requests that reached a terminal outcome",
        )
        self._reg_bad = registry.counter(
            f"{prefix}_bad_total",
            "requests that burned error budget, by reason",
        )
        self._reg_latency = registry.histogram(
            f"{prefix}_latency_seconds", "end-to-end request latency"
        )

    # -- recording -----------------------------------------------------------

    def record_dispatch(
        self,
        *,
        shape: int,
        occupancy: int,
        queue_wait_s: float,
        device_s: float,
        generation: int,
    ) -> None:
        import time

        now = time.perf_counter()
        with self._lock:
            self._dispatches += 1
            self._rows_real += occupancy
            self._rows_padded += shape
            self._queue_wait_s += queue_wait_s
            self._device_s += device_s
            self._shape_counts[shape] = self._shape_counts.get(shape, 0) + 1
            self._gen_dispatches[generation] = (
                self._gen_dispatches.get(generation, 0) + 1
            )
            if self._first_t is None:
                self._first_t = now - device_s - queue_wait_s
            self._last_t = now

    def record_shed(self, reason: str) -> None:
        """One refused request: ``predicted_wait`` (admission said no up
        front) or ``queue_full`` (the bounded full-queue wait expired)."""
        with self._lock:
            self._sheds[reason] = self._sheds.get(reason, 0) + 1
        if self._reg_total is not None:
            self._reg_total.inc()
            self._reg_bad.inc(reason="shed")

    def record_deadline_expired(self, n: int = 1) -> None:
        with self._lock:
            self._deadline_expired += int(n)
        if self._reg_total is not None:
            self._reg_total.inc(n)
            self._reg_bad.inc(n, reason="deadline")

    def record_degraded(self, n: int = 1) -> None:
        with self._lock:
            self._degraded += int(n)
        if self._reg_bad is not None:
            # degraded rows also pass record_latency, which counts them
            # in the total — only the budget burn is added here
            self._reg_bad.inc(n, reason="degraded")

    def record_re_resolution_failure(self, re_type: str) -> None:
        with self._lock:
            self._re_resolution_failures[re_type] = (
                self._re_resolution_failures.get(re_type, 0) + 1
            )

    def record_re_quarantine(self, re_type: str) -> None:
        with self._lock:
            self._re_quarantines[re_type] = (
                self._re_quarantines.get(re_type, 0) + 1
            )

    def record_frontend(self, event: str, n: int = 1) -> None:
        """Front-end counters: ``connections_opened`` / ``_closed`` /
        ``_dropped_slow``, ``lines`` / ``malformed`` / ``oversized`` /
        ``read_faults`` / ``control``."""
        with self._lock:
            self._frontend[event] = self._frontend.get(event, 0) + int(n)

    def record_response(self, status: str) -> None:
        """One wire response by terminal status (``ok`` / ``shed`` /
        ``deadline_exceeded`` / ``error`` / ``degraded`` rides on ok)."""
        with self._lock:
            self._responses[status] = self._responses.get(status, 0) + 1

    def record_drain(self, report) -> None:
        with self._lock:
            self._drain = report.to_dict()

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self._stride == 0:
                self._lat.append(seconds)
                if len(self._lat) >= self._max_samples:
                    # thin deterministically: keep every 2nd sample,
                    # double the stride for future arrivals
                    self._lat = self._lat[::2]
                    self._stride *= 2
        if self._reg_total is not None:
            self._reg_total.inc()
            self._reg_latency.observe(seconds)

    # -- reporting -----------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
            elapsed = (
                (self._last_t - self._first_t)
                if self._first_t is not None and self._last_t is not None
                else 0.0
            )
            out: Dict[str, object] = {
                "requests": self._seen,
                "dispatches": self._dispatches,
                "qps": (
                    round(self._seen / elapsed, 3) if elapsed > 0 else None
                ),
                "batch_occupancy_mean": (
                    round(self._rows_real / self._rows_padded, 6)
                    if self._rows_padded
                    else None
                ),
                "pad_waste_frac": (
                    round(1.0 - self._rows_real / self._rows_padded, 6)
                    if self._rows_padded
                    else None
                ),
                "rows_per_dispatch_mean": (
                    round(self._rows_real / self._dispatches, 3)
                    if self._dispatches
                    else None
                ),
                "queue_wait_s_mean": (
                    round(self._queue_wait_s / self._dispatches, 9)
                    if self._dispatches
                    else None
                ),
                "device_s_mean": (
                    round(self._device_s / self._dispatches, 9)
                    if self._dispatches
                    else None
                ),
                "shape_counts": {
                    str(k): v for k, v in sorted(self._shape_counts.items())
                },
                "generation_dispatches": {
                    str(k): v
                    for k, v in sorted(self._gen_dispatches.items())
                },
                "latency_samples": int(lat.size),
                "latency_sample_stride": self._stride,
                "sheds": {
                    **{k: v for k, v in sorted(self._sheds.items())},
                    "total": sum(self._sheds.values()),
                },
                "deadline_expired": self._deadline_expired,
                "degraded_responses": self._degraded,
                "re_resolution_failures": dict(
                    sorted(self._re_resolution_failures.items())
                ),
                "re_quarantines": dict(
                    sorted(self._re_quarantines.items())
                ),
            }
            if self._frontend:
                out["frontend"] = dict(sorted(self._frontend.items()))
            if self._responses:
                out["responses"] = dict(sorted(self._responses.items()))
            if self._drain is not None:
                out["drain"] = dict(self._drain)
            if lat.size:
                out.update(
                    {
                        "latency_p50_ms": round(
                            float(np.percentile(lat, 50)) * 1e3, 6
                        ),
                        "latency_p99_ms": round(
                            float(np.percentile(lat, 99)) * 1e3, 6
                        ),
                        "latency_max_ms": round(float(lat.max()) * 1e3, 6),
                        "latency_mean_ms": round(
                            float(lat.mean()) * 1e3, 6
                        ),
                    }
                )
            return out

    def write(self, path: str, extra: Optional[Dict] = None) -> None:
        """metrics.json: the serving block + reliability accounting +
        caller extras, atomically."""
        from photon_ml_tpu_torch.reliability import (
            atomic_write_json,
            reliability_metrics,
        )

        atomic_write_json(
            path,
            {
                "serving": self.snapshot(),
                **(extra or {}),
                "reliability": reliability_metrics(),
            },
        )
