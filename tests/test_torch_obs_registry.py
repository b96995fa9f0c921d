"""The port's metrics registry (``obs/registry.py``) against the JAX
package's: the same seeded sequences of inc, set, observe and view go
through both registries, whose snapshots (the scrape timestamp aside)
must be equal and whose Prometheus text must be byte-identical; the
label cap, a clash of kinds, failing views and ``SnapshotWriter``'s
atomic files."""

import json
import time

import numpy as np
import pytest

from photon_ml_tpu.obs import registry as ref_registry
from photon_ml_tpu_torch.obs import registry
from photon_ml_tpu_torch.obs.registry import MetricsRegistry, SnapshotWriter


def _drive(mod, seed, *, n_ops=400, max_label_sets=8):
    """One seeded operation sequence through ``mod``'s registry."""
    rng = np.random.default_rng(seed)
    r = mod.MetricsRegistry(max_label_sets=max_label_sets)
    c = r.counter("reqs_total")
    g = r.gauge("queue_depth")
    h = r.histogram("latency_s", bounds=(0.001, 0.01, 0.1, 1.0))
    state = {"served": 0}
    r.register_view("serving", lambda: {"served": state["served"], "nested": {"qps": 2.5}})
    for _ in range(n_ops):
        op = int(rng.integers(0, 4))
        labels = (
            {} if rng.uniform() < 0.3
            else {"shard": str(int(rng.integers(0, 12)))}
        )
        if op == 0:
            c.inc(float(rng.integers(1, 5)), **labels)
        elif op == 1:
            g.set(float(np.round(rng.normal(), 6)), **labels)
        elif op == 2:
            h.observe(float(10.0 ** rng.uniform(-4, 1)), **labels)
        else:
            state["served"] += 1
    return r


def _without_ts(snap):
    out = dict(snap)
    assert isinstance(out.pop("ts"), float)
    return out


class TestParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_snapshot_and_prometheus_equal_the_reference(self, seed):
        port = _drive(registry, seed)
        ref = _drive(ref_registry, seed)
        assert _without_ts(port.snapshot()) == _without_ts(ref.snapshot())
        assert port.prometheus() == ref.prometheus()

    def test_label_cap_overflows_alike(self):
        port = _drive(registry, 7, max_label_sets=3)
        ref = _drive(ref_registry, 7, max_label_sets=3)
        assert port.counter("reqs_total").series() == ref.counter("reqs_total").series()
        assert port.gauge("queue_depth").series() == ref.gauge("queue_depth").series()
        assert ("__overflow__",) in port.counter("reqs_total").series()
        assert port.prometheus() == ref.prometheus()


class TestRegistry:
    def test_label_cardinality_is_capped(self):
        r = MetricsRegistry(max_label_sets=4)
        c = r.counter("leaky")
        for i in range(50):
            c.inc(uid=f"u{i}")
        series = c.series()
        assert len(series) <= 5
        assert series[("__overflow__",)] == 46
        assert c.total() == 50

    def test_same_name_other_kind_clash_raises(self):
        r = MetricsRegistry()
        assert r.counter("x") is r.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            r.gauge("x")

    def test_failing_view_is_isolated(self):
        r = MetricsRegistry()
        r.register_view("ok_view", lambda: {"a": 1})

        def bad():
            raise RuntimeError("wedged subsystem")

        r.register_view("bad_view", bad)
        snap = r.snapshot()
        assert snap["ok_view"] == {"a": 1}
        assert snap["bad_view"] == {"error": "wedged subsystem"}

    def test_snapshot_writer_writes_atomically(self, tmp_path):
        r = MetricsRegistry()
        r.counter("n").inc(5)
        w = SnapshotWriter(r, str(tmp_path), period_s=0.05).start()
        time.sleep(0.2)
        w.stop()
        assert w.writes >= 2 and w.write_errors == 0
        snap = json.load(open(tmp_path / "metrics_snapshot.json"))
        assert snap["metrics"]["n"]["values"][""] == 5
        # the atomic writer leaves no temporary file behind
        assert sorted(p.name for p in tmp_path.iterdir()) == ["metrics_snapshot.json"]

    def test_default_registry_is_process_wide_until_reset(self):
        a = registry.default_registry()
        assert registry.default_registry() is a
        b = registry.reset_default_registry()
        assert b is not a and registry.default_registry() is b

    def test_serving_metrics_bind_under_the_reference_names(self):
        """``ServingMetrics.bind_registry`` creates the instruments the
        JAX package's does, by name and kind."""
        from photon_ml_tpu.serving.metrics import ServingMetrics as RefServingMetrics
        from photon_ml_tpu_torch.serving.metrics import ServingMetrics

        port, ref = MetricsRegistry(), ref_registry.MetricsRegistry()
        ServingMetrics().bind_registry(port)
        RefServingMetrics().bind_registry(ref)

        def kinds(r):
            return {k: v["kind"] for k, v in r.snapshot()["metrics"].items()}

        assert kinds(port) == kinds(ref) and kinds(port)
