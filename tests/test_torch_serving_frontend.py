"""The port's network front end (``photon_ml_tpu_torch/serving/frontend.py``)
on the CPU: scores over a real socket bitwise the port's batch scorer,
concurrent connections each getting their rows, named errors for
malformed and oversized input and for a planned read fault, readiness
and liveness status ops, the operator's quarantine op, shed and deadline
outcomes on the wire, the drain protocol, and the serving driver's
front-end mode end to end (SIGTERM -> drained exit 0 + interrupted
metrics.json) and its SIGTERM mid-replay. Expected scores come from the
port's batch scorer directly; nothing here imports JAX."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from photon_ml_tpu_torch.game.data import build_game_dataset
from photon_ml_tpu_torch.game.model_io import LoadedGameModel, load_game_model
from photon_ml_tpu_torch.serving import (
    AdmissionController,
    MicroBatcher,
    ServingFrontend,
    ServingMetrics,
    ServingModel,
    ServingPrograms,
    bank_from_arrays,
)
from torch_serving_cases import (
    SHARDS,
    Client,
    batch_reference_scores,
    make_bank,
    synth_model,
    synth_records,
    wait_until,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(recs, shards=SHARDS, re_types=("userId",)):
    return build_game_dataset(recs, shards, list(re_types), device="cpu")


@pytest.fixture
def stack(rng):
    """bank + batcher + frontend on an ephemeral port, torn down in drain
    order."""
    recs = synth_records(rng)
    ds = _dataset(recs)
    lm = synth_model(rng)
    sm = ServingModel(make_bank(lm, ds), ServingPrograms((1, 8)))
    metrics = ServingMetrics()
    batcher = MicroBatcher(sm.current, sm.programs, metrics)
    fe = ServingFrontend(batcher, sm, SHARDS, metrics=metrics, port=0).start()
    yield recs, ds, lm, sm, batcher, metrics, fe
    fe.stop_accepting()
    batcher.drain(10.0)
    fe.close()


class TestFrontendScoring:
    def test_socket_scores_bitwise_match_batch_scorer(self, stack):
        recs, ds, lm, sm, batcher, metrics, fe = stack
        ref = batch_reference_scores(lm, ds)
        c = Client(fe.port)
        try:
            for i in (0, 7, 23, 42):
                resp = c.ask(recs[i])
                assert resp["status"] == "ok", resp
                assert resp["uid"] == recs[i]["uid"]
                assert np.float32(resp["score"]) == ref[i]
                assert resp["degraded"] is False
                assert resp["generation"] == 1
        finally:
            c.close()

    def test_concurrent_connections_each_get_their_rows(self, stack):
        recs, ds, lm, sm, batcher, metrics, fe = stack
        ref = batch_reference_scores(lm, ds)
        errors = []

        def client_worker(idx):
            c = Client(fe.port)
            try:
                for i in idx:
                    resp = c.ask(recs[i])
                    assert resp["status"] == "ok", resp
                    assert np.float32(resp["score"]) == ref[i], i
            except BaseException as e:
                errors.append(e)
            finally:
                c.close()

        threads = [
            threading.Thread(target=client_worker, args=(range(t, 60, 4),))
            for t in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors

    def test_pipelined_lines_coalesce_and_demux(self, stack):
        """A client that sends all its lines before reading gets one
        response per line, each its own row, in fewer dispatches."""
        recs, ds, lm, sm, batcher, metrics, fe = stack
        ref = batch_reference_scores(lm, ds)
        c = Client(fe.port)
        try:
            c.send_line(b"".join((json.dumps(r) + "\n").encode() for r in recs))
            got = {}
            for _ in recs:
                r = c.recv()
                got[r["uid"]] = np.float32(r["score"])
        finally:
            c.close()
        assert [got[r["uid"]] for r in recs] == list(ref)
        assert metrics.snapshot()["dispatches"] < len(recs)

    def test_malformed_lines_get_named_error_and_connection_survives(self, stack):
        recs, ds, lm, sm, batcher, metrics, fe = stack
        c = Client(fe.port)
        try:
            assert c.ask(b"this is not json\n")["error"] == "BAD_REQUEST"
            assert c.ask(b'["a", "json", "array"]\n')["error"] == "BAD_REQUEST"
            assert c.ask({"op": "no-such-op"})["error"] == "BAD_REQUEST"
            assert c.ask(recs[0])["status"] == "ok"
        finally:
            c.close()
        assert metrics.snapshot()["frontend"]["malformed"] >= 2

    def test_oversized_line_is_refused_and_closed(self, stack):
        recs, ds, lm, sm, batcher, metrics, fe = stack
        small = ServingFrontend(
            batcher, sm, SHARDS, metrics=metrics, port=0, max_line_bytes=512,
        ).start()
        try:
            c = Client(small.port)
            c.send_line(b"x" * 2048)
            resp = c.recv()
            assert resp["error"] == "BAD_REQUEST"
            assert "exceeds" in resp["message"]
            assert c.recv() is None
            c.close()
        finally:
            small.stop_accepting()
            small.close()
        assert metrics.snapshot()["frontend"]["oversized"] == 1

    def test_read_fault_seam_yields_named_error(self, stack):
        from photon_ml_tpu_torch.reliability import install_plan

        recs, ds, lm, sm, batcher, metrics, fe = stack
        ref = batch_reference_scores(lm, ds)
        install_plan("serving.frontend.read:2:EIO")
        c = Client(fe.port)
        try:
            assert c.ask(recs[0])["status"] == "ok"
            faulted = c.ask(recs[1])
            assert faulted["status"] == "error"
            assert faulted["error"] == "READ_FAULT"
            ok = c.ask(recs[2])
            assert ok["status"] == "ok"
            assert np.float32(ok["score"]) == ref[2]
        finally:
            c.close()
            install_plan(None)
        assert metrics.snapshot()["frontend"]["read_faults"] == 1


class TestFrontendLifecycle:
    def test_status_reports_ready_and_alive(self, stack):
        recs, ds, lm, sm, batcher, metrics, fe = stack
        c = Client(fe.port)
        try:
            for op in ("status", "ready", "live"):
                resp = c.ask({"op": op})
                assert resp["status"] == "ok"
                assert resp["ready"] is True
                assert resp["alive"] is True
                assert resp["draining"] is False
                assert resp["generation"] == 1
                assert resp["heartbeat_age_s"] < 5.0
        finally:
            c.close()

    def test_not_ready_when_ladder_cold(self, rng):
        recs = synth_records(rng, n=5)
        ds = _dataset(recs)
        sm = ServingModel(make_bank(synth_model(rng), ds), ServingPrograms((1, 8)))
        assert sm.ready()
        sm.programs._max_entries = 1
        other = bank_from_arrays(
            fixed=[("global", "g", np.ones(16, np.float32))],
            shard_widths={"g": 4}, device="cpu",
        )
        sm.programs.ensure_compiled(other)
        assert not sm.ready()

    def test_drain_refuses_new_work_finishes_old_zero_leaks(self, stack):
        recs, ds, lm, sm, batcher, metrics, fe = stack
        c = Client(fe.port)
        assert c.ask(recs[0])["status"] == "ok"
        fe.stop_accepting()
        with pytest.raises(OSError):
            Client(fe.port, timeout=2.0)
        resp = c.ask(recs[1])
        assert resp["status"] == "error" and resp["error"] == "CLOSED"
        report = batcher.drain(5.0)
        assert report.failed == 0 and not report.timed_out
        fe.close()
        assert fe.open_connections() == 0
        assert c.recv() is None
        c.close()
        snap = metrics.snapshot()
        assert snap["frontend"]["connections_opened"] >= 1
        assert snap["drain"]["failed"] == 0

    def test_quarantine_re_op_degrades_scores_on_the_wire(self, stack):
        recs, ds, lm, sm, batcher, metrics, fe = stack
        fe_only = LoadedGameModel()
        fe_only.fixed_effects = dict(lm.fixed_effects)
        ref_full = batch_reference_scores(lm, ds)
        ref_fe = batch_reference_scores(fe_only, ds)
        c = Client(fe.port)
        try:
            before = c.ask(recs[0])
            assert before["status"] == "ok" and not before["degraded"]
            assert np.float32(before["score"]) == ref_full[0]
            assert c.ask({"op": "quarantine_re", "re_type": "nope"})["error"] == "BAD_REQUEST"
            resp = c.ask({"op": "quarantine_re", "re_type": "userId"})
            assert resp["status"] == "ok" and resp["re_type"] == "userId"
            after = c.ask(recs[0])
            assert after["status"] == "ok" and after["degraded"] is True
            assert np.float32(after["score"]) == ref_fe[0]
        finally:
            c.close()

    def test_shed_and_deadline_surface_on_the_wire(self, rng):
        recs = synth_records(rng)
        ds = _dataset(recs)
        sm = ServingModel(make_bank(synth_model(rng), ds), ServingPrograms((1, 8)))
        admission = AdmissionController()
        admission.note_dispatch(rows=1, busy_s=10.0)
        gate = threading.Lock()
        gate.acquire()
        metrics = ServingMetrics()
        batcher = MicroBatcher(
            sm.current, sm.programs, metrics, swap_lock=gate, admission=admission,
        )
        fe = ServingFrontend(batcher, sm, SHARDS, metrics=metrics, port=0).start()
        c = Client(fe.port)
        try:
            c.send_line(recs[0])
            assert wait_until(lambda: not batcher._queue and batcher._inflight)
            c.send_line(recs[1])
            assert wait_until(lambda: len(batcher._queue) == 1)
            shed_req = dict(recs[2])
            shed_req["deadline_ms"] = 40.0
            resp = c.ask(shed_req)
            assert resp["status"] == "shed" and resp["error"] == "SHED"
            expire_req = dict(recs[3])
            expire_req["deadline_ms"] = 1e9
            c.send_line(expire_req)
            assert wait_until(lambda: len(batcher._queue) == 2)
            with batcher._lock:
                for q_req, _f in batcher._queue:
                    if q_req.uid == expire_req["uid"]:
                        q_req.deadline_ms = 0.5
            time.sleep(0.05)
            gate.release()
            got = {}
            for _ in range(3):
                r = c.recv()
                got[r["uid"]] = r
            assert got[recs[0]["uid"]]["status"] == "ok"
            assert got[recs[1]["uid"]]["status"] == "ok"
            assert got[expire_req["uid"]]["status"] == "deadline_exceeded"
        finally:
            c.close()
            batcher.drain(5.0)
            fe.stop_accepting()
            fe.close()
        snap = metrics.snapshot()
        assert snap["sheds"]["total"] == 1
        assert snap["deadline_expired"] == 1


def _save_fe_model(tmp_path, recs):
    """An on-disk GAME model + name-term lists without training: an
    FE-only model over the trace's vocabulary."""
    from photon_ml_tpu_torch.game.model_io import save_loaded_game_model
    from photon_ml_tpu_torch.io.name_term_list import save_name_and_term_feature_sets

    lm = LoadedGameModel()
    lm.fixed_effects["global"] = (
        "g", {f"g{j}\t": float(v) for j, v in enumerate(np.linspace(-1.0, 1.0, 5))},
    )
    model_dir = str(tmp_path / "model")
    save_loaded_game_model(lm, model_dir)
    nt_dir = str(tmp_path / "name-terms")
    save_name_and_term_feature_sets({"features": {f"g{j}\t" for j in range(5)}}, nt_dir)
    return model_dir, nt_dir, _dataset(recs, [SHARDS[0]], [])


class TestDriverFrontEnd:
    def test_sigterm_drains_and_writes_interrupted_metrics(self, tmp_path, rng):
        """``python -m photon_ml_tpu_torch.cli.serving_driver
        --frontend-port 0 --device cpu``: the published port, scores over
        TCP bitwise the batch scorer's over the saved artifact, status,
        then SIGTERM — exit 0 and metrics.json with the interrupted run,
        the drain report and zero leaked connections."""
        recs = synth_records(rng, n=20)
        model_dir, nt_dir, ds = _save_fe_model(tmp_path, recs)
        out_dir = str(tmp_path / "serve-out")
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
                "--game-model-input-dir", model_dir, "--output-dir", out_dir,
                "--feature-shard-id-to-feature-section-keys-map", "g:features",
                "--feature-name-and-term-set-path", nt_dir,
                "--request-nnz-width", "g:8", "--frontend-port", "0",
                "--drain-timeout", "10", "--ladder", "1,8", "--device", "cpu",
            ],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            fj = os.path.join(out_dir, "frontend.json")
            assert wait_until(lambda: os.path.exists(fj), timeout=120)
            published = json.load(open(fj))
            assert published["wire"]["protocols"] == ["json", "binary"]
            c = Client(published["port"], timeout=30)
            status = c.ask({"op": "status"})
            assert status["ready"] is True and status["alive"] is True
            got = {}
            for i in range(10):
                resp = c.ask(recs[i])
                assert resp["status"] == "ok", resp
                got[resp["uid"]] = np.float32(resp["score"])
            ref = batch_reference_scores(load_game_model(model_dir), ds)
            for i in range(10):
                assert got[recs[i]["uid"]] == ref[i], i
            c.close()
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
            assert proc.returncode == 0, out[-4000:]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        m = json.load(open(os.path.join(out_dir, "metrics.json")))
        assert m["interrupted"] is True
        assert m["mode"] == "frontend"
        assert m["leaked_connections"] == 0
        assert m["drain"]["timed_out"] is False
        assert m["frontend_completed"] == 10
        assert m["serving"]["responses"]["ok"] >= 10
        assert m["readbacks"] == m["serving"]["dispatches"] >= 1
        assert "reliability" in m

    def test_sigterm_mid_replay_drains_and_keeps_partial_accounting(self, tmp_path, rng):
        from conftest import game_example_schema

        from photon_ml_tpu_torch.cli.serving_driver import ServingDriver, params_from_args
        from photon_ml_tpu_torch.io.avro_codec import read_avro_records, write_container

        n = 3000
        recs = synth_records(rng, n=n)
        model_dir, _nt, _ds = _save_fe_model(tmp_path, recs)
        trace = tmp_path / "trace"
        trace.mkdir()
        write_container(str(trace / "part-0.avro"), game_example_schema(), [
            {k: r[k] for k in ("uid", "response", "metadataMap", "features", "userFeatures")}
            for r in recs
        ])
        out_dir = str(tmp_path / "out")
        driver = ServingDriver(params_from_args([
            "--game-model-input-dir", model_dir, "--output-dir", out_dir,
            "--request-paths", str(trace),
            "--feature-shard-id-to-feature-section-keys-map", "g:features",
            "--ladder", "1,8", "--drain-timeout", "10", "--device", "cpu",
        ]))

        def killer():
            assert wait_until(
                lambda: driver.metrics is not None
                and driver.metrics.snapshot()["requests"] >= 20,
                timeout=60,
            )
            os.kill(os.getpid(), signal.SIGTERM)

        t = threading.Thread(target=killer)
        t.start()
        driver.run()
        t.join(timeout=10)
        assert driver.interrupted
        m = json.load(open(os.path.join(out_dir, "metrics.json")))
        assert m["interrupted"] is True
        ok = m["outcomes"]["ok"]
        assert 20 <= ok < n
        assert m["drain"]["timed_out"] is False
        assert ok <= m["serving"]["requests"] <= ok + 1
        assert len(list(read_avro_records(os.path.join(out_dir, "scores")))) == ok
