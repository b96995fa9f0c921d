"""The port's fleet telemetry (``obs/fleet.py``) on the CPU: cursor-keyed
``{"op": "trace"}`` polls that never duplicate or drop a span (ring
evictions counted); ``stitch_spans``, ``verify_fleet_trace`` and
``fleet_check_conservation`` fed the same payloads as the JAX package's
and giving equal output; one live collector over two shard-server
subprocesses across a two-step flip and a SIGKILL, whose merged trace
verifies and whose fleet books balance (and fail when a response is
dropped); the ``python -m photon_ml_tpu_torch.obs.fleet`` merge CLI on
good and broken books."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from photon_ml_tpu.obs import fleet as ref_fleet
from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.game.data import build_game_dataset
from photon_ml_tpu_torch.obs.fleet import (
    FleetCollector,
    fleet_check_conservation,
    main as fleet_main,
    stitch_spans,
    verify_fleet_trace,
)
from photon_ml_tpu_torch.obs.flight_recorder import FlightRecorder
from photon_ml_tpu_torch.obs.trace import (
    Tracer,
    export_chrome_trace,
    reset_tracer,
    tracer,
    tracing_scope,
)
from photon_ml_tpu_torch.serving import (
    MicroBatcher,
    RoutingPolicy,
    ServingFrontend,
    ServingMetrics,
    ServingModel,
    ServingPrograms,
    ShardRouter,
)
from torch_fleet_cases import synthetic_records
from torch_serving_cases import SHARDS, Client, make_bank, synth_model, synth_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = sorted(f"user{i:02d}" for i in range(14))

# One synthetic shard-server process of the port: its own tracer epoch,
# flight recorder and clock. Banks are seeded, so every shard of a
# generation agrees with every other process that builds it.
SHARD_SCRIPT = r"""
import json, os, sys, time
import numpy as np
from photon_ml_tpu_torch.game.config import FeatureShardConfiguration
from photon_ml_tpu_torch.serving import (
    ServingModel, ServingPrograms, ShardServer, bank_from_arrays,
)
from photon_ml_tpu_torch.utils.index_map import IndexMap

shard, count = int(sys.argv[1]), int(sys.argv[2])
E, d_g, d_u = 14, 6, 4
ids = sorted(f"user{i:02d}" for i in range(E))
SHARDS = [
    FeatureShardConfiguration("g", ["features"]),
    FeatureShardConfiguration("u", ["userFeatures"]),
]
imaps = {
    "g": IndexMap({f"g{j}\t": j for j in range(d_g)}),
    "u": IndexMap({f"u{j}\t": j for j in range(d_u)}),
}

def build(gen):
    rng = np.random.default_rng(1234 + gen)
    fe = rng.standard_normal(d_g).astype(np.float32)
    re = rng.standard_normal((E, d_u)).astype(np.float32)
    return bank_from_arrays(
        fixed=[("global", "g", fe)],
        random=[("per-user", "userId", "u", re, ids)],
        shard_widths={"g": 4, "u": 4}, index_maps=imaps,
        entity_shard=(shard, count), device="cpu",
    )

sm = ServingModel(build(1), ServingPrograms((1, 8)), partial=True,
                  entity_shard=(shard, count))
srv = ShardServer(sm, SHARDS, (shard, count),
                  stager=lambda obj: sm.prepare_swap_bank(build(2)),
                  has_response=False).start()
print(json.dumps({"port": srv.port, "pid": os.getpid()}), flush=True)
while True:
    time.sleep(0.1)
"""


@pytest.fixture
def traced_frontend(rng):
    recs = synth_records(rng)
    ds = build_game_dataset(recs, SHARDS, ["userId"], device="cpu")
    bank = make_bank(synth_model(rng), ds)
    sm = ServingModel(bank, ServingPrograms((1, 8)))
    metrics = ServingMetrics()
    batcher = MicroBatcher(sm.current, sm.programs, metrics)
    fe = ServingFrontend(batcher, sm, SHARDS, metrics=metrics, port=0).start()
    with tracing_scope(True):
        tracer().clear()
        yield recs, fe
    fe.stop_accepting()
    batcher.drain(10.0)
    fe.close()
    batcher.close()


class TestTraceOp:
    def test_cursor_polls_never_duplicate_or_drop(self, traced_frontend):
        recs, fe = traced_frontend
        c = Client(fe.port)
        try:
            for r in recs[:5]:
                assert c.ask(r)["status"] == "ok"
            r1 = c.ask({"op": "trace", "cursor": 0, "uid": "t1"})
            assert r1["status"] == "ok" and r1["uid"] == "t1"
            assert r1["dropped"] == 0 and r1["enabled"] is True
            assert r1["pid"] == os.getpid()
            for key in ("epoch_wall", "epoch_perf", "now_perf", "max_spans"):
                assert key in r1, key
            seqs = [s["seq"] for s in r1["spans"]]
            assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
            assert r1["cursor"] == seqs[-1]
            assert {"frontend.request", "serving.dispatch"} <= {s["name"] for s in r1["spans"]}
            r2 = c.ask({"op": "trace", "cursor": r1["cursor"]})
            assert r2["spans"] == [] and r2["cursor"] == r1["cursor"]
            for r in recs[5:8]:
                assert c.ask(r)["status"] == "ok"
            r3 = c.ask({"op": "trace", "cursor": r2["cursor"]})
            new_seqs = [s["seq"] for s in r3["spans"]]
            assert new_seqs and min(new_seqs) > r1["cursor"]
            assert set(seqs) | set(new_seqs) == {s.seq for s in tracer().snapshot()}
            tracer().clear()
            for r in recs[8:10]:
                assert c.ask(r)["status"] == "ok"
            assert c.ask({"op": "trace", "cursor": r3["cursor"]})["spans"]
            bad = c.ask({"op": "trace", "cursor": "xyz"})
            assert bad["status"] == "error" and bad["error"] == "BAD_REQUEST"
        finally:
            c.close()

    def test_evictions_between_polls_are_counted(self, traced_frontend, monkeypatch):
        recs, fe = traced_frontend
        monkeypatch.setenv("PHOTON_TRACE_SPANS", "8")
        t = reset_tracer()
        try:
            assert t.max_spans == 8
            c = Client(fe.port)
            try:
                for r in recs[:12]:
                    assert c.ask(r)["status"] == "ok"
                resp = c.ask({"op": "trace", "cursor": 0})
            finally:
                c.close()
            assert resp["max_spans"] == 8
            assert resp["dropped"] > 0 and len(resp["spans"]) <= 8
        finally:
            monkeypatch.delenv("PHOTON_TRACE_SPANS")
            reset_tracer()


# -- the same payloads through both packages ----------------------------------


def _mk_payload(name, spans, *, offset=0.0, unc=0.001, pid=100):
    return {
        "name": name, "pid": pid, "spans": spans, "epoch_wall": 0.0,
        "epoch_perf": 0.0, "offset_s": offset, "offset_unc_s": unc,
        "wall_mapped": False,
    }


def _span(name, sid, t0, t1, *, trace="tr1", parent=None, attrs=None, seq=1):
    return {
        "name": name, "trace_id": trace, "span_id": sid, "parent_id": parent,
        "t0": t0, "t1": t1, "tid": 1, "seq": seq, "attrs": dict(attrs or {}),
    }


def _random_fleet_payloads(seed, n_shards=3, n_requests=20):
    """Router and shard payloads of a seeded fleet run: each request a
    router span with sub-requests, each sub-request a frontend span on
    its shard and a dispatch leaf; shard clocks skewed; some spans
    misplaced so that verification has violations to report."""
    rng = np.random.default_rng(seed)
    skews = rng.uniform(-0.05, 0.05, n_shards)
    router, shards = [], [[] for _ in range(n_shards)]
    t = 10.0
    for i in range(n_requests):
        tr = f"tr{i}"
        root = _span("router.request", f"r{i}", t, t + 0.01, trace=tr, seq=2 * i)
        router.append(root)
        for k, s in enumerate(rng.choice(n_shards, size=int(rng.integers(1, 3)), replace=False)):
            s = int(s)
            sub_id = f"s{i}.{k}"
            router.append(_span("router.subrequest", sub_id, t + 0.001, t + 0.009,
                                trace=tr, parent=root["span_id"],
                                attrs={"shard": s}, seq=2 * i + 1))
            late = rng.uniform() < 0.1  # a child stamped before its parent
            f0 = t + (0.0005 if late else 0.002) - skews[s] * (0 if late else 1)
            fid = f"f{i}.{k}"
            shards[s].append(_span("frontend.request", fid, f0, f0 + 0.005,
                                   trace=tr, parent=sub_id, seq=len(shards[s])))
            shards[s].append(_span("serving.dispatch", f"d{i}.{k}", f0 + 0.001,
                                   f0 + 0.003, trace=f"td{i}",
                                   attrs={"generation": 1 + int(i > n_requests // 2),
                                          "shape": 8, "traces": [[tr, fid, False]]},
                                   seq=len(shards[s])))
        t += float(rng.uniform(0.01, 0.02))
    payloads = [_mk_payload("router", router, unc=0.0)]
    for s in range(n_shards):
        payloads.append(_mk_payload(f"shard{s}", shards[s], offset=float(skews[s]),
                                    unc=float(rng.uniform(0, 0.001)), pid=200 + s))
    return payloads


def _random_books(seed, n_shards=3):
    rng = np.random.default_rng(seed)
    router = FlightRecorder(4096)
    shard_recs = [FlightRecorder(4096) for _ in range(n_shards)]
    for _ in range(int(rng.integers(50, 120))):
        router.note_admitted()
        kind = int(rng.integers(0, 5))
        gen = int(rng.integers(1, 3))
        if kind < 3:
            s = int(rng.integers(0, n_shards))
            router.note_terminal("ok", generation=gen, attribution=f"shard:{s}")
            shard_recs[s].note_admitted()
            shard_recs[s].note_terminal("ok", generation=gen)
        elif kind == 3:
            router.note_terminal("ok", generation=gen, attribution="cache")
        else:
            router.note_terminal("ok", generation=gen, attribution="degraded")
    books = {
        f"shard{s}": {
            "conservation": rec.check_conservation(),
            "complete": bool(s != n_shards - 1 or rng.uniform() < 0.5),
            "shard_indices": [s],
        }
        for s, rec in enumerate(shard_recs)
    }
    return router.check_conservation(), books


class TestParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_stitch_and_verify_equal_the_reference(self, seed):
        payloads = _random_fleet_payloads(seed)
        got = stitch_spans(json.loads(json.dumps(payloads)))
        want = ref_fleet.stitch_spans(json.loads(json.dumps(payloads)))
        assert got == want
        assert verify_fleet_trace(got) == ref_fleet.verify_fleet_trace(want)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_conservation_equals_the_reference(self, seed):
        router_book, books = _random_books(seed)
        got = fleet_check_conservation(router_book, books)
        assert got == ref_fleet.fleet_check_conservation(router_book, books)
        # a dropped response: admitted, never terminal
        router_book = dict(router_book, admitted=router_book["admitted"] + 1, ok=False)
        bad = fleet_check_conservation(router_book, books)
        assert bad == ref_fleet.fleet_check_conservation(router_book, books)
        assert not bad["ok"]

    def test_skew_correction_restores_parent_child_monotonicity(self):
        skew = 0.050
        router = [_span("router.request", "r1", 10.000, 10.010),
                  _span("router.subrequest", "s1", 10.001, 10.009, parent="r1")]
        shard = [_span("frontend.request", "f1", 10.002 - skew, 10.008 - skew, parent="s1")]
        stitched = stitch_spans([
            _mk_payload("router", router, offset=0.0, unc=0.0),
            _mk_payload("shard0", shard, offset=-skew, unc=0.0005, pid=200),
        ])
        assert verify_fleet_trace(stitched)["ok"]
        f1 = next(s for s in stitched if s["span_id"] == "shard0:f1")
        assert abs(f1["t0"] - 10.002) < 1e-9 and f1["parent_id"] == "router:s1"
        v2 = verify_fleet_trace(stitch_spans([
            _mk_payload("router", router, offset=0.0, unc=0.0),
            _mk_payload("shard0", shard, offset=0.0, unc=0.0005, pid=200),
        ]))
        assert not v2["ok"]
        assert any("before its parent" in x for x in v2["violations"])


# -- one live collector over a two-subprocess fleet ---------------------------


@pytest.fixture
def shard_fleet():
    env = {**os.environ, "PHOTON_TRACE": "1"}
    procs = []
    try:
        for s in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", SHARD_SCRIPT, str(s), "2"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, text=True,
            ))
        meta = []
        for p in procs:
            line = p.stdout.readline()
            assert line, "shard subprocess died before binding"
            meta.append(json.loads(line))
        yield procs, meta
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


class TestFleetCollectorLive:
    def test_fleet_trace_and_conservation_across_swap_and_kill(self, shard_fleet, rng, tmp_path):
        procs, meta = shard_fleet
        ports = [m["port"] for m in meta]
        router_book = FlightRecorder(capacity=4096)
        with tracing_scope(True):
            tracer().clear()
            router = ShardRouter(
                [("127.0.0.1", pt) for pt in ports],
                entity_ids={"userId": IDS},
                shard_configs=SHARDS,
                policy=RoutingPolicy(subrequest_timeout_s=5.0),
                recorder=router_book,
            )
            router.connect()
            collector = FleetCollector(
                [("shard0", "127.0.0.1", ports[0]), ("shard1", "127.0.0.1", ports[1])],
                local_name="router",
                connect_timeout_s=10.0,
            )
            try:
                recs = synthetic_records(rng, IDS, n=24)
                assert not any(router.score_record(r).degraded for r in recs)
                assert all(collector.poll_once().values())
                assert any(router.score_record(r).cache_hit for r in recs)
                res = router.coordinate_swap("synthetic")
                assert res["ok"] and res["generation"] == 2, res
                assert all(router.score_record(r).generation == 2 for r in recs)
                collector.poll_once()
                procs[1].kill()
                procs[1].wait(timeout=30)
                variants = json.loads(json.dumps(recs))
                for v in variants:
                    for bag in ("features", "userFeatures"):
                        for f in v[bag]:
                            f["value"] = float(f["value"]) * 1.25 + 0.5
                n_deg = 0
                for rec in variants:
                    o = router.score_record(rec)
                    owner = ownership.owner_of(IDS.index(rec["metadataMap"]["userId"]), 2)
                    assert o.degraded is (owner == 1), rec["uid"]
                    n_deg += owner == 1
                assert n_deg > 0
                collector.stop(final_poll=True)
                status = collector.member_status()
                assert status["shard1"]["errors"] >= 1 and status["shard1"]["spans"] > 0
                assert status["shard0"]["ring_dropped"] == 0
                # the merged trace verifies, and the JAX package stitches
                # the same payloads into the same trace
                stitched = collector.stitched_spans()
                verdict = verify_fleet_trace(stitched)
                assert verdict["ok"], verdict["violations"]
                assert verdict["router_subrequests"] > 0 and verdict["score_leaves"] > 0
                assert {s["member"] for s in stitched} == {"router", "shard0", "shard1"}
                payloads = json.loads(json.dumps(collector._payloads()))
                assert ref_fleet.stitch_spans(payloads) == stitch_spans(payloads)
                gens = {s["attrs"].get("generation") for s in stitched
                        if s["name"] == "serving.dispatch"}
                assert {1, 2} <= gens, gens
                out = str(tmp_path / "fleet_trace.json")
                n = collector.export(out)
                data = json.load(open(out))
                assert len(data["traceEvents"]) == n
                assert data["otherData"]["verification"]["ok"]
                # fleet conservation across the flip and the kill
                flight = collector.collect_flight()
                assert flight["shard0"]["complete"] and not flight["shard1"]["complete"]
                books = {
                    name: {
                        "conservation": flight[name].get("conservation") or {},
                        "complete": flight[name]["complete"],
                        "shard_indices": [i],
                    }
                    for i, name in enumerate(("shard0", "shard1"))
                }
                cons = fleet_check_conservation(router_book.check_conservation(), books)
                assert cons["ok"], cons
                assert cons == ref_fleet.fleet_check_conservation(
                    router_book.check_conservation(), books
                )
                attr = cons["terminal_by_attribution"]
                assert attr.get("cache", 0) > 0 and attr.get("degraded", 0) >= n_deg
                assert cons["shards"]["shard0"]["join_ok"] is True
                assert cons["shards"]["shard1"]["join_ok"] is None
                router_book.note_admitted()  # a dropped response
                assert not fleet_check_conservation(router_book.check_conservation(), books)["ok"]
            finally:
                router.close()


# -- the post-hoc merge CLI ---------------------------------------------------


class TestPostHocMerge:
    def _write_dirs(self, tmp_path):
        router_dir, shard_dir = tmp_path / "router-obs", tmp_path / "shard0-obs"
        router_dir.mkdir()
        shard_dir.mkdir()
        rt = Tracer(64)
        root = rt.start("router.request", attrs={"uid": "q1"})
        sub = rt.start("router.subrequest", trace_id=root.trace_id,
                       parent_id=root.span_id, attrs={"shard": 0})
        st = Tracer(64)
        f = st.start("frontend.request", trace_id=root.trace_id, parent_id=sub.span_id)
        st.record("serving.dispatch", f.t0, f.t0 + 0.001,
                  attrs={"generation": 1, "shape": 1,
                         "traces": [(root.trace_id, f.span_id, False)]})
        f.end()
        sub.end()
        root.end()
        export_chrome_trace(str(router_dir / "trace.json"), rt.snapshot())
        export_chrome_trace(str(shard_dir / "trace.json"), st.snapshot())
        router_rec = FlightRecorder(64)
        router_rec.note_admitted()
        router_rec.note_terminal("ok", generation=1, attribution="shard:0")
        router_rec.record("swap.fleet_commit", generation=1)
        router_rec.dump(str(router_dir / "flight.json"), reason="exit")
        shard_rec = FlightRecorder(64)
        shard_rec.note_admitted()
        shard_rec.note_terminal("ok", generation=1)
        shard_rec.record("swap.commit", generation=1)
        shard_rec.dump(str(shard_dir / "flight.json"), reason="drain")
        return router_dir, shard_dir

    def test_cli_merges_and_verifies_as_the_reference(self, tmp_path, capsys):
        router_dir, shard_dir = self._write_dirs(tmp_path)
        out, ref_out = tmp_path / "merged", tmp_path / "ref-merged"
        assert fleet_main([str(router_dir), str(shard_dir), "-o", str(out)]) == 0
        assert ref_fleet.main([str(router_dir), str(shard_dir), "-o", str(ref_out)]) == 0
        data = json.load(open(out / "fleet_trace.json"))
        ver = data["otherData"]["verification"]
        assert ver["ok"], ver["violations"]
        assert ver["score_leaves"] == 1
        assert ver == json.load(open(ref_out / "fleet_trace.json"))["otherData"]["verification"]
        instants = {e["name"] for e in data["traceEvents"] if e.get("ph") == "i"}
        assert {"swap.fleet_commit", "swap.commit"} <= instants
        cons = json.load(open(out / "fleet_conservation.json"))
        assert cons["ok"] and cons["terminal_by_attribution"] == {"shard:0": 1}
        assert cons == json.load(open(ref_out / "fleet_conservation.json"))

    def test_cli_fails_on_broken_books(self, tmp_path, capsys):
        router_dir, shard_dir = self._write_dirs(tmp_path)
        flight = json.load(open(router_dir / "flight.json"))
        flight["conservation"]["admitted"] += 1
        flight["conservation"]["ok"] = False
        json.dump(flight, open(router_dir / "flight.json", "w"))
        out = tmp_path / "merged"
        rc = fleet_main([str(router_dir), str(shard_dir), "--router", "router-obs",
                         "-o", str(out)])
        assert rc == 1
        assert not json.load(open(out / "fleet_conservation.json"))["ok"]

    def test_module_entry_point(self, tmp_path):
        router_dir, shard_dir = self._write_dirs(tmp_path)
        r = subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.obs.fleet",
             str(router_dir), str(shard_dir), "-o", str(tmp_path / "m")],
            cwd=REPO, capture_output=True, text=True,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert json.loads(r.stdout)["conservation_ok"] is True
