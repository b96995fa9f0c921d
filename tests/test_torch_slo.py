"""The port's SLO engine (``obs/slo.py``) against the JAX package's:
spec parsing, and seeded tick sequences on one virtual clock through
both engines, whose verdicts, alert and clear events and ``slo_*``
gauges must be equal; the burst that pages, the blip that does not, and
a latency objective over a registry histogram."""

import importlib

import numpy as np
import pytest

from photon_ml_tpu_torch.obs.flight_recorder import FlightRecorder
from photon_ml_tpu_torch.obs.registry import MetricsRegistry
from photon_ml_tpu_torch.obs.slo import (
    SLOEngine,
    SLOSpec,
    default_router_slos,
    default_serving_slos,
    parse_slo_specs,
)

SPECS_JSON = (
    '[{"name": "avail", "objective": 0.9, "metric": "req_total", '
    '"bad_metric": "req_bad", "short_window_s": 10, "long_window_s": 60, '
    '"burn_threshold": 2.0}, '
    '{"name": "lat", "objective": 0.9, "kind": "latency", "metric": "lat_s", '
    '"latency_threshold_s": 0.1, "short_window_s": 10, "long_window_s": 60, '
    '"burn_threshold": 2.0}]'
)


def _run(mods, seed, n_ticks=240):
    """Seeded traffic with two error bursts through one engine of
    ``mods`` = (registry, slo, flight_recorder); returns the verdicts,
    the recorder's events (kind and fields) and the final gauges."""
    reg_mod, slo_mod, fr_mod = mods
    rng = np.random.default_rng(seed)
    reg = reg_mod.MetricsRegistry()
    total, bad = reg.counter("req_total"), reg.counter("req_bad")
    lat = reg.histogram("lat_s", bounds=(0.01, 0.1, 1.0))
    rec = fr_mod.FlightRecorder(capacity=256)
    eng = slo_mod.SLOEngine(reg, slo_mod.parse_slo_specs(SPECS_JSON), recorder=rec)
    bursts = {int(rng.integers(60, 90)), int(rng.integers(150, 170))}
    verdicts = []
    t, burning = 0.0, 0
    for i in range(n_ticks):
        if i in bursts:
            burning = int(rng.integers(3, 40))
        n = int(rng.integers(50, 150))
        err = 0.8 if burning else 0.01
        total.inc(n)
        bad.inc(int(n * err))
        for _ in range(int(rng.integers(5, 15))):
            lat.observe(5.0 if burning and rng.uniform() < 0.6 else 0.05)
        burning = max(burning - 1, 0)
        verdicts.append(eng.tick(t))
        t += 1.0
    events = [(e["kind"], e.get("fields")) for e in rec.events()]
    gauges = {
        name: reg.gauge(name).series()
        for name in ("slo_alert", "slo_burn_rate", "slo_error_rate")
    }
    status = eng.status()
    return verdicts, events, gauges, status


PORT = tuple(
    importlib.import_module(f"photon_ml_tpu_torch.obs.{m}")
    for m in ("registry", "slo", "flight_recorder")
)
REF = tuple(
    importlib.import_module(f"photon_ml_tpu.obs.{m}")
    for m in ("registry", "slo", "flight_recorder")
)
ref_slo = REF[1]


class TestParity:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_tick_sequences_equal_the_reference(self, seed):
        got, want = _run(PORT, seed), _run(REF, seed)
        assert got[0] == want[0]  # every tick's verdicts
        assert got[1] == want[1]  # alert / clear events with their fields
        assert got[2] == want[2]  # the slo_* gauges
        assert got[3] == want[3]
        assert any(k == "slo.alert" for k, _ in got[1])

    def test_spec_parsing_equals_the_reference(self):
        for text in (SPECS_JSON, "default"):
            got = [s.as_dict() for s in parse_slo_specs(text)]
            want = [s.as_dict() for s in ref_slo.parse_slo_specs(text)]
            assert got == want
        assert [s.as_dict() for s in default_router_slos()] == [
            s.as_dict() for s in ref_slo.default_router_slos()
        ]
        for bad in ('{"name": "a", "objective": 1.5, "metric": "t", "bad_metric": "b"}',
                    '{"name": "a", "objective": 0.9, "metric": "t", "bad_metric": "b", '
                    '"shortwindow": 5}',
                    ""):
            with pytest.raises(ValueError) as port_err:
                parse_slo_specs(bad)
            with pytest.raises(ValueError) as ref_err:
                ref_slo.parse_slo_specs(bad)
            assert str(port_err.value) == str(ref_err.value)


class TestEngine:
    def _avail_spec(self):
        return SLOSpec(
            name="avail", objective=0.9, kind="availability",
            metric="req_total", bad_metric="req_bad",
            short_window_s=10.0, long_window_s=60.0, burn_threshold=2.0,
        ).validate()

    def test_burst_fires_alert_as_flight_event_and_gauge(self):
        reg = MetricsRegistry()
        total, bad = reg.counter("req_total"), reg.counter("req_bad")
        rec = FlightRecorder(capacity=64)
        eng = SLOEngine(reg, [self._avail_spec()], recorder=rec)
        t = 0.0
        for _ in range(70):
            total.inc(100)
            bad.inc(1)
            eng.tick(t)
            t += 1.0
        assert not eng.alert_active("avail")
        fired = False
        for _ in range(60):
            total.inc(100)
            bad.inc(80)
            eng.tick(t)
            t += 1.0
            if eng.alert_active("avail"):
                fired = True
                break
        assert fired
        alert = next(e for e in rec.events() if e["kind"] == "slo.alert")
        assert alert["fields"]["slo"] == "avail" and alert["fields"]["burn_short"] > 2.0
        assert reg.gauge("slo_alert").value(slo="avail") == 1.0
        for _ in range(30):
            total.inc(100)
            eng.tick(t)
            t += 1.0
            if not eng.alert_active("avail"):
                break
        assert not eng.alert_active("avail")
        assert "slo.clear" in [e["kind"] for e in rec.events()]
        assert eng.status()["alerts_fired"] == 1

    def test_short_blip_does_not_page(self):
        reg = MetricsRegistry()
        total, bad = reg.counter("req_total"), reg.counter("req_bad")
        eng = SLOEngine(reg, [self._avail_spec()])
        t = 0.0
        for _ in range(70):
            total.inc(100)
            eng.tick(t)
            t += 1.0
        for _ in range(3):
            total.inc(100)
            bad.inc(80)
            eng.tick(t)
            t += 1.0
        assert reg.gauge("slo_burn_rate").value(slo="avail", window="short") > 2.0
        assert not eng.alert_active("avail")

    def test_latency_threshold_must_be_a_bucket_bound(self):
        reg = MetricsRegistry()
        reg.histogram("lat_s", bounds=(0.01, 0.1, 1.0))
        spec = SLOSpec(
            name="lat", objective=0.9, kind="latency", metric="lat_s",
            latency_threshold_s=0.07,
        ).validate()
        with pytest.raises(ValueError, match="not a bucket bound"):
            SLOEngine(reg, [spec]).tick(0.0)

    def test_default_specs(self):
        assert parse_slo_specs("default") == default_serving_slos()
        assert default_router_slos()[0].metric == "router_requests_total"
