"""Declarative SLOs with multi-window burn-rate alerting (a copy of
``photon_ml_tpu/obs/slo.py``).

An :class:`SLOSpec` names an objective — availability ("99% of
requests reach a good outcome") or a latency percentile ("99% of
requests complete within 25ms") — and the :class:`SLOEngine` evaluates
it over the live metrics registry: availability over a (bad, total)
counter pair, latency over a registry *histogram* (the good fraction
is the cumulative bucket count at the threshold bound, so the
threshold must be one of the histogram's bounds — approximating
between bounds would silently move the objective).

**Burn rate**, not raw error fraction: ``burn = error_rate /
(1 - objective)`` — the rate at which the error *budget* is being
spent. 1.0 means the budget lasts exactly the SLO period; 10 means a
tenth of that. Alerting is **multi-window** (the SRE-workbook shape):
an alert fires only when BOTH a short and a long window burn past the
threshold — the short window makes detection fast and makes the alert
RESET fast once the burst ends, the long window keeps one transient
blip from paging. Both windows are measured over the same cumulative
counters by differencing a ring of periodic samples, so the engine
never needs per-request state.

Alerts are filed as flight-recorder events (``slo.alert`` /
``slo.clear`` — they ride the ring into every dump) and exposed as
registry gauges (``slo_burn_rate{slo=...,window=...}``,
``slo_alert{slo=...}``), so both the post-mortem and the live scrape
see them. A health window can consume the alert state instead of raw
error fractions via :meth:`SLOEngine.any_alert_active`.

Host arithmetic only: nothing in obs/ touches a device tensor.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "SLOSpec",
    "parse_slo_specs",
    "default_serving_slos",
    "default_router_slos",
    "SLOEngine",
]

KINDS = ("availability", "latency")


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    ``kind="availability"``: ``metric`` names the TOTAL counter and
    ``bad_metric`` the bad-event counter (both registry counters,
    summed over label sets). ``kind="latency"``: ``metric`` names a
    registry histogram and ``latency_threshold_s`` one of its bucket
    bounds; an observation above the bound is a budget-burning event.

    ``burn_threshold`` is the budget-spend multiple that pages (e.g.
    2.0 = the budget would be gone in half the SLO period); the alert
    fires only when BOTH windows burn past it.
    """

    name: str
    objective: float
    kind: str = "availability"
    metric: str = ""
    bad_metric: str = ""
    latency_threshold_s: float = 0.0
    short_window_s: float = 60.0
    long_window_s: float = 720.0
    burn_threshold: float = 2.0

    def validate(self) -> "SLOSpec":
        if not self.name:
            raise ValueError("SLOSpec needs a name")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), got "
                f"{self.objective}"
            )
        if self.kind not in KINDS:
            raise ValueError(
                f"SLO {self.name!r}: kind must be one of {KINDS}, got "
                f"{self.kind!r}"
            )
        if not self.metric:
            raise ValueError(f"SLO {self.name!r}: metric is required")
        if self.kind == "availability" and not self.bad_metric:
            raise ValueError(
                f"SLO {self.name!r}: availability needs bad_metric"
            )
        if self.kind == "latency" and self.latency_threshold_s <= 0:
            raise ValueError(
                f"SLO {self.name!r}: latency needs latency_threshold_s"
            )
        if not 0 < self.short_window_s < self.long_window_s:
            raise ValueError(
                f"SLO {self.name!r}: need 0 < short_window_s < "
                f"long_window_s, got {self.short_window_s}/"
                f"{self.long_window_s}"
            )
        if self.burn_threshold <= 0:
            raise ValueError(
                f"SLO {self.name!r}: burn_threshold must be > 0"
            )
        return self

    def as_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "objective": self.objective,
            "kind": self.kind,
            "metric": self.metric,
            "bad_metric": self.bad_metric,
            "latency_threshold_s": self.latency_threshold_s,
            "short_window_s": self.short_window_s,
            "long_window_s": self.long_window_s,
            "burn_threshold": self.burn_threshold,
        }


def parse_slo_specs(text: str) -> List[SLOSpec]:
    """``--slo`` grammar: inline JSON (one object or a list), ``@path``
    to a JSON file, or the literal ``default`` (the serving specs).
    Unknown keys are rejected — a typo'd window must not silently
    become the default."""
    text = (text or "").strip()
    if not text:
        raise ValueError("empty SLO spec")
    if text == "default":
        return default_serving_slos()
    if text.startswith("@"):
        with open(text[1:]) as f:
            payload = json.load(f)
    else:
        payload = json.loads(text)
    if isinstance(payload, Mapping):
        payload = [payload]
    specs: List[SLOSpec] = []
    fields = set(SLOSpec.__dataclass_fields__)
    for obj in payload:
        unknown = set(obj) - fields
        if unknown:
            raise ValueError(
                f"unknown SLO spec key(s) {sorted(unknown)}; known: "
                f"{sorted(fields)}"
            )
        specs.append(SLOSpec(**obj).validate())
    if len({s.name for s in specs}) != len(specs):
        raise ValueError("duplicate SLO spec names")
    return specs


def default_serving_slos(
    *, latency_threshold_s: float = 0.025
) -> List[SLOSpec]:
    """The single-server serving plane's instruments (see
    ``ServingMetrics.bind_registry``)."""
    return [
        SLOSpec(
            name="serving-availability",
            objective=0.99,
            kind="availability",
            metric="serving_requests_total",
            bad_metric="serving_bad_total",
        ).validate(),
        SLOSpec(
            name="serving-latency",
            objective=0.99,
            kind="latency",
            metric="serving_latency_seconds",
            latency_threshold_s=latency_threshold_s,
        ).validate(),
    ]


def default_router_slos() -> List[SLOSpec]:
    """The routed plane's instruments (``RouterMetrics.bind_registry``)."""
    return [
        SLOSpec(
            name="router-availability",
            objective=0.99,
            kind="availability",
            metric="router_requests_total",
            bad_metric="router_bad_total",
        ).validate(),
        SLOSpec(
            name="router-latency",
            objective=0.99,
            kind="latency",
            metric="router_latency_seconds",
            latency_threshold_s=0.25,
        ).validate(),
    ]


class SLOEngine:
    """Evaluates SLO specs over a metrics registry on a tick cadence.

    ``tick(now)`` is deterministic (tests drive it with a synthetic
    clock); :meth:`start`/:meth:`stop` run it on a background thread.
    Each tick samples every spec's cumulative (bad, total), appends to
    a bounded per-spec ring, differences the ring at the short and long
    window edges, and updates gauges + alert state. All registry /
    recorder calls happen OUTSIDE the engine's own lock.
    """

    def __init__(
        self,
        registry,
        specs: Sequence[SLOSpec],
        *,
        recorder=None,
        sources: Optional[
            Mapping[str, Callable[[], Tuple[float, float]]]
        ] = None,
        max_samples: int = 4096,
    ):
        self.registry = registry
        self.specs = [s.validate() for s in specs]
        self.recorder = recorder
        self.sources = dict(sources or {})
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {
            s.name: deque(maxlen=self.max_samples) for s in self.specs
        }
        self._active: Dict[str, bool] = {s.name: False for s in self.specs}
        self._last_eval: Dict[str, Dict[str, object]] = {}
        self._alerts_fired = 0  # photon: guarded-by(_lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # single-writer publish: start() sets it before the thread runs
        self._period_s = 1.0  # photon: guarded-by(atomic)
        # gauges are created once up front (get-or-create is idempotent)
        self._g_burn = registry.gauge(
            "slo_burn_rate",
            "error-budget burn rate per SLO and window",
        )
        self._g_alert = registry.gauge(
            "slo_alert",
            "1 while the SLO's multi-window burn-rate alert is active",
        )
        self._g_err = registry.gauge(
            "slo_error_rate", "windowed bad/total per SLO (short window)"
        )

    # -- sampling -------------------------------------------------------------

    def _counts(self, spec: SLOSpec) -> Tuple[float, float]:
        """Cumulative (bad, total) for one spec. Resolution order:
        an explicit source callable, then registry instruments."""
        src = self.sources.get(spec.metric)
        if src is not None:
            bad, total = src()
            return float(bad), float(total)
        if spec.kind == "availability":
            total = self.registry.counter(spec.metric).total()
            bad = self.registry.counter(spec.bad_metric).total()
            return float(bad), float(total)
        hist = self.registry.histogram(spec.metric)
        idx = None
        for i, b in enumerate(hist.bounds):
            if abs(b - spec.latency_threshold_s) <= 1e-12:
                idx = i
                break
        if idx is None:
            raise ValueError(
                f"SLO {spec.name!r}: threshold "
                f"{spec.latency_threshold_s} is not a bucket bound of "
                f"{spec.metric!r} (bounds: {hist.bounds})"
            )
        good = 0.0
        total = 0.0
        for cell in hist.series().values():
            total += cell["count"]
            good += sum(cell["buckets"][: idx + 1])
        return total - good, total

    @staticmethod
    def _window_delta(samples, now: float, window_s: float, bad, total):
        """Difference the cumulative counters against the newest sample
        at least ``window_s`` old (or the oldest available — a short
        history reports over what it has, with the actual span)."""
        edge = None
        for t, b, n in samples:  # oldest -> newest
            if t <= now - window_s:
                edge = (t, b, n)
            else:
                break
        if edge is None and samples:
            edge = samples[0]
        if edge is None:
            return 0.0, 0.0, 0.0
        t0, b0, n0 = edge
        return bad - b0, total - n0, now - t0

    def tick(self, now: Optional[float] = None) -> Dict[str, Dict]:
        """One evaluation pass; returns per-spec verdicts."""
        now = time.monotonic() if now is None else float(now)
        out: Dict[str, Dict] = {}
        transitions: List[Tuple[SLOSpec, bool, Dict]] = []
        for spec in self.specs:
            bad, total = self._counts(spec)
            with self._lock:
                ring = self._samples[spec.name]
                ring.append((now, bad, total))
                samples = list(ring)
            budget = 1.0 - spec.objective
            burns = {}
            rates = {}
            for label, w in (
                ("short", spec.short_window_s),
                ("long", spec.long_window_s),
            ):
                d_bad, d_total, span = self._window_delta(
                    samples, now, w, bad, total
                )
                rate = (d_bad / d_total) if d_total > 0 else 0.0
                rates[label] = rate
                burns[label] = rate / budget
            active = (
                burns["short"] > spec.burn_threshold
                and burns["long"] > spec.burn_threshold
            )
            verdict = {
                "kind": spec.kind,
                "objective": spec.objective,
                "burn_short": round(burns["short"], 6),
                "burn_long": round(burns["long"], 6),
                "error_rate_short": round(rates["short"], 6),
                "burn_threshold": spec.burn_threshold,
                "alert": active,
                "bad": bad,
                "total": total,
            }
            out[spec.name] = verdict
            # read-modify-write of the alert state in ONE critical
            # section: the transition decision is made on the value
            # read under this lock, never on a stale pre-compute peek
            with self._lock:
                was_active = self._active[spec.name]
                self._active[spec.name] = active
                self._last_eval[spec.name] = verdict
                if active and not was_active:
                    self._alerts_fired += 1
            # gauges + flight events outside the engine lock
            self._g_burn.set(burns["short"], slo=spec.name, window="short")
            self._g_burn.set(burns["long"], slo=spec.name, window="long")
            self._g_err.set(rates["short"], slo=spec.name)
            self._g_alert.set(1.0 if active else 0.0, slo=spec.name)
            if active != was_active:
                transitions.append((spec, active, verdict))
        if self.recorder is not None:
            for spec, active, verdict in transitions:
                self.recorder.record(
                    "slo.alert" if active else "slo.clear",
                    slo=spec.name,
                    objective=spec.objective,
                    burn_short=verdict["burn_short"],
                    burn_long=verdict["burn_long"],
                    burn_threshold=spec.burn_threshold,
                )
        return out

    # -- state ----------------------------------------------------------------

    def alert_active(self, name: str) -> bool:
        with self._lock:
            return bool(self._active.get(name))

    def any_alert_active(self) -> bool:
        """The registry watcher's ``burn_gate``: "is ANY declared SLO
        burning its budget past threshold on both windows right now" —
        burn-rate semantics in place of the raw error fraction."""
        with self._lock:
            return any(self._active.values())

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "specs": [s.as_dict() for s in self.specs],
                "alerts_active": sorted(
                    n for n, a in self._active.items() if a
                ),
                "alerts_fired": self._alerts_fired,
                "last_eval": {
                    k: dict(v) for k, v in self._last_eval.items()
                },
            }

    # -- background cadence ---------------------------------------------------

    def start(self, period_s: float = 1.0) -> "SLOEngine":
        self._period_s = max(float(period_s), 0.02)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="photon-slo-engine", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self._period_s):
            try:
                self.tick()
            except ValueError:
                # a spec referencing a not-yet-populated histogram must
                # not kill the cadence; it resolves once traffic flows
                continue

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
