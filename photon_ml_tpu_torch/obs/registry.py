"""Process-wide metrics registry (a copy of ``photon_ml_tpu/obs/registry.py``,
retargeted at the port's atomic writer): counters / gauges / bounded
histograms with capped label cardinality, plus read-only VIEWS over the
subsystem accumulators that already exist.

The pre-obs state was per-subsystem snapshots that only materialize in
``metrics.json`` at exit — ``ServingMetrics``, ``RouterMetrics``, the
``utils/profiling`` host-timing buckets, the reliability accounting.
This registry makes them ONE live surface without rewriting any of
them: a subsystem registers a zero-arg ``view`` callable (its existing
``snapshot()``), and :meth:`MetricsRegistry.snapshot` merges every view
next to the registry's own instruments. The frontend's
``{"op": "metrics"}`` control op serves that merged snapshot live
(JSON, or Prometheus-style text via ``{"format": "prometheus"}``), and
:class:`SnapshotWriter` persists it periodically under ``--obs-dir``
through the reliability layer's atomic writers.

Concurrency discipline: every mutable structure in this
module is guarded by its owner's single ``_lock``; instrument updates
are one short critical section with no foreign calls inside. Label
cardinality is CAPPED — past ``max_label_sets`` distinct label tuples,
updates collapse into one ``__overflow__`` series (counted), so a
label leak (e.g. a uid smuggled into a label) degrades resolution, not
host memory. Everything here is host arithmetic: obs code never
touches a device tensor.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SnapshotWriter",
    "default_registry",
    "reset_default_registry",
]

DEFAULT_MAX_LABEL_SETS = 64
DEFAULT_HISTOGRAM_BOUNDS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
OVERFLOW = ("__overflow__",)


def _label_key(labels: Mapping[str, str]) -> Tuple[str, ...]:
    return tuple(f"{k}={labels[k]}" for k in sorted(labels))


class _Instrument:
    """Shared label-cardinality plumbing. Subclasses hold per-label
    values in ``self._values`` under ``self._lock``."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, max_label_sets: int):
        self.name = name
        self.help = help_text
        self._max_label_sets = int(max_label_sets)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], object] = {}
        self._overflowed = 0  # photon: guarded-by(_lock)

    def _slot(self, labels: Optional[Mapping[str, str]]) -> Tuple[str, ...]:  # photon: guarded-by(_lock)
        key = _label_key(labels) if labels else ()
        if key not in self._values and len(self._values) >= self._max_label_sets:
            self._overflowed += 1
            return OVERFLOW
        return key

    def series(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._values)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                "|".join(k) if k else "": v for k, v in self._values.items()
            }
            if self._overflowed:
                out["__overflow_updates__"] = self._overflowed
            return out


class Counter(_Instrument):
    """Monotone counter, optionally labelled: ``c.inc(3, shard="1")``."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        with self._lock:
            key = self._slot(labels)
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels) if labels else (), 0))

    def total(self) -> float:
        with self._lock:
            return float(sum(
                v for k, v in self._values.items() if k != OVERFLOW
            ) + (self._values.get(OVERFLOW) or 0))


class Gauge(_Instrument):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[self._slot(labels)] = float(v)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            v = self._values.get(_label_key(labels) if labels else ())
            return None if v is None else float(v)


class Histogram(_Instrument):
    """Fixed-bound bucketed histogram (cumulative on export, like the
    Prometheus convention): bounded memory regardless of traffic."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        max_label_sets: int,
        bounds: Sequence[float] = DEFAULT_HISTOGRAM_BOUNDS,
    ):
        super().__init__(name, help_text, max_label_sets)
        self.bounds = tuple(sorted(float(b) for b in bounds))

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        with self._lock:
            key = self._slot(labels)
            cell = self._values.get(key)
            if cell is None:
                cell = {
                    "count": 0,
                    "sum": 0.0,
                    "buckets": [0] * (len(self.bounds) + 1),
                }
                self._values[key] = cell
            cell["count"] += 1
            cell["sum"] += v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    cell["buckets"][i] += 1
                    break
            else:
                cell["buckets"][-1] += 1

    def count(self, **labels) -> int:
        with self._lock:
            cell = self._values.get(_label_key(labels) if labels else ())
            return 0 if cell is None else int(cell["count"])


class MetricsRegistry:
    """Name -> instrument map plus the subsystem views.

    ``counter``/``gauge``/``histogram`` are get-or-create (same name ->
    same instrument; a kind clash raises — two subsystems silently
    sharing a name with different types is a bug, not a merge).
    """

    def __init__(self, *, max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        self._lock = threading.Lock()
        self._max_label_sets = int(max_label_sets)
        self._instruments: Dict[str, _Instrument] = {}
        self._views: Dict[str, Callable[[], object]] = {}

    def _get_or_create(self, name: str, factory, kind: str):  # photon: guarded-by(_lock)
        inst = self._instruments.get(name)
        if inst is None:
            inst = factory()
            self._instruments[name] = inst
        elif inst.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {kind}"
            )
        return inst

    def counter(self, name: str, help_text: str = "") -> Counter:
        with self._lock:
            return self._get_or_create(
                name,
                lambda: Counter(name, help_text, self._max_label_sets),
                "counter",
            )

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        with self._lock:
            return self._get_or_create(
                name,
                lambda: Gauge(name, help_text, self._max_label_sets),
                "gauge",
            )

    def histogram(
        self,
        name: str,
        help_text: str = "",
        bounds: Sequence[float] = DEFAULT_HISTOGRAM_BOUNDS,
    ) -> Histogram:
        with self._lock:
            return self._get_or_create(
                name,
                lambda: Histogram(
                    name, help_text, self._max_label_sets, bounds
                ),
                "histogram",
            )

    def register_view(self, name: str, fn: Callable[[], object]) -> None:
        """Attach a zero-arg callable whose result is merged into every
        snapshot under ``name`` — how ServingMetrics / RouterMetrics /
        host timings / reliability accounting join the live surface
        without being rewritten. Re-registering a name replaces it."""
        with self._lock:
            self._views[name] = fn

    def unregister_view(self, name: str) -> None:
        with self._lock:
            self._views.pop(name, None)

    def _parts(self):
        with self._lock:
            return list(self._instruments.values()), dict(self._views)

    def snapshot(self) -> Dict[str, object]:  # photon: entropy(live metrics surface; ts is the scrape timestamp by contract)
        """The live merged surface: registry instruments + every view.
        A failing view reports its error in place — one wedged
        subsystem must not take down the metrics op."""
        instruments, views = self._parts()
        out: Dict[str, object] = {
            "ts": time.time(),
            "metrics": {
                inst.name: {
                    "kind": inst.kind,
                    "values": inst.snapshot(),
                }
                for inst in sorted(instruments, key=lambda i: i.name)
            },
        }
        for name in sorted(views):
            try:
                out[name] = views[name]()
            except Exception as e:
                out[name] = {"error": str(e)}
        return out

    # -- Prometheus-style text exposition ------------------------------------

    def prometheus(self) -> str:
        """Flat ``# TYPE`` + sample lines for the registry's own
        instruments plus every view's NUMERIC leaves (nested view dicts
        flatten to ``view_key_subkey`` names) — enough for a scrape
        without a client-library dependency."""
        instruments, views = self._parts()
        lines: List[str] = []

        def sanitize(name: str) -> str:
            return "".join(
                c if c.isalnum() or c == "_" else "_" for c in name
            )

        def label_parts(key) -> List[str]:
            if key and key != ("",):
                return [part.replace("=", '="', 1) + '"' for part in key]
            return []

        def sample(name, key, value, extra: str = ""):
            parts = label_parts(key)
            if extra:
                parts.append(extra)
            if parts:
                lines.append(f"{name}{{{','.join(parts)}}} {value}")
            else:
                lines.append(f"{name} {value}")

        for inst in sorted(instruments, key=lambda i: i.name):
            name = sanitize(inst.name)
            lines.append(f"# TYPE {name} {inst.kind}")
            for key, v in sorted(inst.series().items()):
                if inst.kind == "histogram":
                    sample(f"{name}_count", key, v["count"])
                    sample(f"{name}_sum", key, v["sum"])
                    # _bucket lines merge the series' label set with
                    # le, exactly like sample() renders it — two label
                    # sets of one histogram must never emit colliding
                    # unlabeled {le=...} samples
                    cum = 0
                    for b, n in zip(inst.bounds, v["buckets"]):
                        cum += n
                        sample(
                            f"{name}_bucket", key, cum,
                            extra=f'le="{b}"',
                        )
                    cum += v["buckets"][-1]
                    sample(
                        f"{name}_bucket", key, cum, extra='le="+Inf"'
                    )
                else:
                    sample(name, key, v)

        def flatten(prefix: str, obj) -> None:
            if isinstance(obj, Mapping):
                for k in sorted(obj):
                    flatten(f"{prefix}_{sanitize(str(k))}", obj[k])
            elif isinstance(obj, bool):
                lines.append(f"{prefix} {int(obj)}")
            elif isinstance(obj, (int, float)) and obj == obj:
                lines.append(f"{prefix} {obj}")

        for vname in sorted(views):
            try:
                payload = views[vname]()
            except Exception:
                lines.append(f"# view {sanitize(vname)} failed")
                continue
            flatten(sanitize(vname), payload)
        return "\n".join(lines) + "\n"


class SnapshotWriter:
    """Periodic ``--obs-dir`` snapshot thread: every ``period_s`` (and
    once at :meth:`stop`) the merged registry snapshot lands atomically
    in ``<obs_dir>/metrics_snapshot.json`` — a crash leaves the previous
    complete snapshot, never a torn one."""

    def __init__(
        self,
        registry: MetricsRegistry,
        obs_dir: str,
        *,
        period_s: float = 5.0,
        filename: str = "metrics_snapshot.json",
    ):
        self.registry = registry
        self.path = os.path.join(obs_dir, filename)
        self.period_s = max(float(period_s), 0.05)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.writes = 0  # photon: guarded-by(_lock)
        self.write_errors = 0  # photon: guarded-by(_lock)
        self._thread: Optional[threading.Thread] = None

    def _write_once(self) -> None:
        from photon_ml_tpu_torch.reliability import atomic_write_json

        try:
            atomic_write_json(self.path, self.registry.snapshot())
            with self._lock:
                self.writes += 1
        except OSError:
            # a full/unwritable obs dir must never take down the
            # process it observes; the error count is itself visible
            with self._lock:
                self.write_errors += 1

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.period_s):
            self._write_once()

    def start(self) -> "SnapshotWriter":
        self._thread = threading.Thread(
            target=self._loop, name="photon-obs-snapshot", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Final snapshot + join: the exit-time file is always current."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        self._write_once()


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use). Drivers wire
    their subsystem views into THIS one so one ``{"op": "metrics"}``
    answers for the whole process."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Fresh process-wide registry (tests / driver re-entry)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = MetricsRegistry()
        return _DEFAULT
